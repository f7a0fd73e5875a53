"""K14's two-shot all-reduce modelled on the CPU.

The CUDA kernel (``csrc/ring.cu``) gives chunk r to owner rank r, which
reads it from every rank's input and sums it in the ring's order (its own
value first), segment by segment over its blocks, and writes each sum into
every rank's output. ``two_shot`` below is that ownership and that order
in PyTorch. Held bit for bit to ``ring_all_reduce_plain`` and to the JAX
package's ring on the multi-device TPU interpreter at n = 2, 4 and 8, in
f32 and bf16, whatever the blocks a rank; and the wrapper's layout helper
passes aligned tensors as they are and pads only a ragged size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu_torch.ops import hopper_collectives as hc
from tests.test_torch_collectives import _jax_ring

torch.set_num_threads(1)


def two_shot(xs, blocks: int) -> list[torch.Tensor]:
    """The kernel's arithmetic: owner r's block j sums segment j of chunk r
    (16-byte vectors, segments of whole vectors) over the n inputs in the
    order r, r+1, ..., r-1 and writes the sum into all n outputs."""
    n = len(xs)
    ins, chunk, _ = hc.kernel_layout(xs)
    outs = [torch.full_like(t, float("nan")) for t in ins]
    vec = 16 // ins[0].element_size()
    chunk_vec = chunk // vec
    seg = -(-chunk_vec // blocks)
    for r in range(n):
        for j in range(blocks):
            lo = r * chunk + min(j * seg, chunk_vec) * vec
            hi = r * chunk + min((j + 1) * seg, chunk_vec) * vec
            acc = ins[r][lo:hi].clone()
            for q in range(1, n):
                acc = acc + ins[(r + q) % n][lo:hi]
            for q in range(n):
                outs[q][lo:hi] = acc
    total = xs[0].numel()
    return [o[:total].reshape(xs[0].shape) for o in outs]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_shot_bit_equal_to_plain_and_jax_ring(n, dtype):
    """The cases of test_ring_plain_bit_equal_to_jax_interpreted_ring:
    ranks of very different magnitudes, so the order of the sums shows in
    the bits."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 5, 211))  # 1055 elements: ragged chunks
         * rng.uniform(0.01, 1000.0, (n, 1, 1))).astype(np.float32)
    xt = torch.from_numpy(x)
    xj = x
    if dtype == "bf16":
        xt = xt.bfloat16()
        xj = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    xs = [xt[r] for r in range(n)]
    want = _jax_ring(xj, n)
    plain = hc.ring_all_reduce_plain(xs)
    for blocks in (1, 3):
        got = two_shot(xs, blocks)
        for r in range(n):
            assert torch.equal(got[r], plain[r])
            np.testing.assert_array_equal(got[r].float().numpy(), want[r])


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_two_shot_aligned_sizes_and_many_blocks(n):
    """Sizes that are a multiple of n * 128 (the kernel reads the callers'
    tensors as they are) and ragged ones, over 1-7 blocks a rank."""
    g = torch.Generator().manual_seed(n)
    for size, dt in ((n * 128, torch.float32), (n * 128 * 5, torch.bfloat16),
                     (n * 128 + 1, torch.float32), (333, torch.bfloat16)):
        xs = [(torch.randn(size, generator=g) * 10.0 ** (r - n // 2)).to(dt) for r in range(n)]
        keep = [x.clone() for x in xs]
        plain = hc.ring_all_reduce_plain(xs)
        for blocks in (1, 2, 7):
            for a, b in zip(two_shot(xs, blocks), plain):
                assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(xs, keep))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_layout_pads_only_the_ragged_case(n):
    g = torch.Generator().manual_seed(n)
    xs = [torch.randn(3, n * 128, generator=g) for _ in range(n)]  # 3 n 128 elements
    ins, chunk, padded = hc.kernel_layout(xs)
    assert not padded and chunk == 3 * 128
    for a, x in zip(ins, xs):  # views of the callers' tensors: no copy
        assert a.data_ptr() == x.data_ptr() and a.shape == (x.numel(),)
    for size in (n * 128 + 1, 127, 1):
        ys = [torch.randn(size, generator=g) for _ in range(n)]
        ins, chunk, padded = hc.kernel_layout(ys)
        assert padded and chunk % 128 == 0 and n * chunk >= size
        for a, y in zip(ins, ys):
            assert a.shape == (n * chunk,) and a.data_ptr() != y.data_ptr()
            assert torch.equal(a[:size], y) and not a[size:].any()
    # an aligned size that is not contiguous is staged as well
    zs = [torch.randn(n * 128, 2, generator=g).t() for _ in range(n)]
    assert hc.kernel_layout(zs)[2]
