"""The two kernels of the port's parallel path on the CPU, against the JAX
package's Pallas kernels run by its interpreters:

- K14, the ring all-reduce: ``ring_all_reduce_plain`` sums each chunk in
  the ring's order, bit for bit as ``pallas_collectives.ring_all_reduce``
  on the multi-device TPU interpreter (as tests/test_parallel.py runs it);
- K12's partials mode: ``decode_attention(partials=True)`` gives the
  unnormalised flash state of ``pallas_attn.decode_attention(partials=
  True)`` in interpret mode, an empty shard included, and the merge of the
  partials of S-shards is plain mode over the whole cache.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from calm_tpu.ops import pallas_attn
from calm_tpu.ops.pallas_collectives import ring_all_reduce as jring
from calm_tpu_torch.ops import hopper_attn
from calm_tpu_torch.ops import hopper_collectives as hc

torch.set_num_threads(1)


def _jax_ring(x: np.ndarray, n: int) -> np.ndarray:
    """JAX's ring over n CPU devices: x (n, ...) is rank r's data at r."""
    mesh = Mesh(np.asarray(jax.devices("cpu")[:n]), ("r",))
    interp = pltpu.InterpretParams(detect_races=True)

    def per_shard(xs):
        return jring(xs[0], "r", n, interpret=interp)[None]

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=P("r"), out_specs=P("r"),
                               check_vma=False))
    return np.asarray(fn(jnp.asarray(x)).astype(jnp.float32))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_plain_bit_equal_to_jax_interpreted_ring(n, dtype):
    """Ranks of very different magnitudes, so that the order of the sums
    shows in the bits: the plain ring and JAX's agree exactly, every rank."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 5, 211))  # 1055 elements: 2 or 3 chunks in use
         * rng.uniform(0.01, 1000.0, (n, 1, 1))).astype(np.float32)
    xt = torch.from_numpy(x)
    xj = x
    if dtype == "bf16":
        xt = xt.bfloat16()
        xj = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    want = _jax_ring(xj, n)
    got = hc.ring_all_reduce_plain([xt[r] for r in range(n)])
    for r in range(n):
        np.testing.assert_array_equal(got[r].float().numpy(), want[r])
    if n > 2:  # the order shows: starting each chunk at the next rank differs
        flat = xt.reshape(n, -1)
        total = flat.shape[1]
        chunk = -(-(-(-total // n)) // 128) * 128
        other = torch.empty_like(flat[0])
        for c in range(-(-total // chunk)):
            seg = slice(c * chunk, min(total, (c + 1) * chunk))
            acc = flat[(c + 1) % n, seg]
            for j in range(2, n + 1):
                acc = acc + flat[(c + j) % n, seg]
            other[seg] = acc
        assert not torch.equal(other, got[0].reshape(-1))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_plain_ragged_sizes_and_cpu_wrapper(n):
    """Sizes that leave chunks ragged (1, 127, n * 128 + 1 elements): the
    sum of every rank's data on every rank; the wrapper on CPU tensors is
    the plain version."""
    g = torch.Generator().manual_seed(n)
    for size in (1, 127, n * 128 + 1):
        xs = [torch.randn(size, generator=g) for _ in range(n)]
        got = hc.ring_all_reduce(xs)
        want = hc.ring_all_reduce_plain(xs)
        assert len(got) == n and hc.ring_all_reduce.launches == 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a, torch.stack(xs).sum(0), rtol=1e-6, atol=1e-6)


def _cache(rng, kv, shape):
    jdt = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}[kv]
    tdt = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}[kv]
    j = jnp.asarray(rng.standard_normal(shape) * 0.5, jdt)
    a = np.asarray(j)
    t = (torch.from_numpy(a.view(np.uint8).copy()).view(tdt) if kv == "fp8"
         else torch.from_numpy(a.astype(np.float32)).to(tdt))
    return j, t


@pytest.fixture
def interpret():
    pallas_attn.set_interpret(True)
    yield
    pallas_attn.set_interpret(False)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_partials_plain_matches_jax_interpret(rng, interpret, kv):
    """acc, m, l of each query row over the rows below kv_len, one slot's
    shard empty (kv_len 0: m = -inf, l = 0, acc = 0 on both sides). The
    TPU kernel rounds q and p to bf16, hence the tolerance; the plain
    version is also held to the exact state in numpy."""
    L, B, KVH, M, S, hd = 2, 3, 2, 4, 256, 64
    layer = 1
    q = rng.standard_normal((B, KVH * M, hd)).astype(np.float32)
    kj, kt = _cache(rng, kv, (L, B, KVH, S, hd))
    vj, vt = _cache(rng, kv, (L, B, KVH, S, hd))
    kv_len = np.array([100, 0, 256], np.int32)
    acc, m, l = hopper_attn.decode_attention(torch.from_numpy(q), kt, vt,
                                             torch.from_numpy(kv_len), layer,
                                             partials=True)
    ja, jm, jl = (np.asarray(t) for t in pallas_attn.decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(kv_len), jnp.int32(layer), partials=True))
    assert acc.shape == (B, KVH * M, hd) and m.shape == l.shape == (B, KVH * M, 1)
    assert np.all(np.isneginf(m[1].numpy())) and np.all(np.isneginf(jm[1]))
    assert not l[1].any() and not acc[1].any() and not jl[1].any() and not ja[1].any()
    live = [0, 2]
    np.testing.assert_allclose(m[live].numpy(), jm[live], rtol=2e-2, atol=2e-2)
    # the state up to its max: numerator and sum both carry exp(-m)
    for b in live:
        sa = np.exp(m[b].numpy() - jm[b])
        np.testing.assert_allclose(l[b].numpy() * sa, jl[b], rtol=3e-2)
        np.testing.assert_allclose(acc[b].numpy() * sa, ja[b], rtol=3e-2,
                                   atol=3e-2 * np.abs(ja[b]).max())
    kf = np.asarray(kj[layer], np.float32)
    vf = np.asarray(vj[layer], np.float32)
    for b in live:
        for h in range(KVH * M):
            sc = kf[b, h // M, :kv_len[b]] @ q[b, h] / math.sqrt(hd)
            p = np.exp(sc - sc.max())
            np.testing.assert_allclose(m[b, h, 0].item(), sc.max(), rtol=1e-5)
            np.testing.assert_allclose(l[b, h, 0].item(), p.sum(), rtol=1e-5)
            np.testing.assert_allclose(acc[b, h].numpy(), p @ vf[b, h // M, :kv_len[b]],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shards", [2, 4])
def test_partials_merge_over_shards_is_plain_mode(rng, shards):
    """The S-shards' partials merged with one max and two sums, as sp
    decode merges them across ranks, give plain mode over the whole cache,
    shards past kv_len (empty) included."""
    L, B, KVH, M, S, hd = 1, 2, 2, 3, 128, 32
    q = torch.from_numpy(rng.standard_normal((B, KVH * M, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((L, B, KVH, S, hd)).astype(np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal((L, B, KVH, S, hd)).astype(np.float32)).bfloat16()
    kv_len = torch.tensor([40, 128], dtype=torch.int32)
    want = hopper_attn.decode_attention(q, kc, vc, kv_len, 0)
    s_loc = S // shards
    parts = []
    for i in range(shards):
        rows = slice(i * s_loc, (i + 1) * s_loc)
        kv_loc = (kv_len - i * s_loc).clamp(0, s_loc).to(torch.int32)
        parts.append(hopper_attn.decode_attention(
            q, kc[:, :, :, rows].contiguous(), vc[:, :, :, rows].contiguous(), kv_loc, 0,
            partials=True))
    mg = torch.stack([p[1] for p in parts]).amax(0)
    num = sum(p[0] * torch.exp(p[1] - mg) for p in parts)
    den = sum(p[2] * torch.exp(p[1] - mg) for p in parts)
    torch.testing.assert_close(num / den, want, rtol=1e-5, atol=1e-5)
    assert hopper_attn.decode_attention.partials_launches == 0  # the CPU: plain


def test_partials_take_neither_fresh_rows_nor_pages():
    q = torch.zeros((1, 2, 64))
    kc = torch.zeros((1, 1, 1, 8, 64), dtype=torch.bfloat16)
    kv_len = torch.tensor([3], dtype=torch.int32)
    fresh = (kc[0, :, :, 0], kc[0, :, :, 0], torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="partials"):
        hopper_attn.decode_attention(q, kc, kc, kv_len, 0, fresh=fresh, partials=True)
    with pytest.raises(ValueError, match="partials"):
        hopper_attn.decode_attention(q, kc, kc, kv_len, 0,
                                     pt=torch.zeros((1, 1), dtype=torch.int32),
                                     partials=True)
