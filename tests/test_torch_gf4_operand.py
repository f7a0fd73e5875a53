"""K4/K5's rounding contract on the CPU: the gf4 matmul kernel reads x as
bf16, rounded once outside it (``hopper_qmm.prefill_operand``, which the
model calls once for wq/wk/wv and once for w1/w3), and that rounding is
JAX's: ``qmm_prefill_plain`` on bf16-rounded x agrees with JAX's
``qmm_prefill`` and ``qmm_prefill_t`` in interpret mode within 1e-5 of the
output's scale (both then multiply exact bf16 operands with f32 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import quant as jquant
from calm_tpu.ops import pallas_qmm
from calm_tpu_torch import model as TM
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.qmm import QTensor

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)


def _gf4_stack(rng, L, d, n):
    return np.stack([jquant.quantize((rng.standard_normal((d, n)) * 0.1).astype(np.float32),
                                     "gf4") for _ in range(L)])


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("rows,d,n", [(32, 384, 256), (100, 256, 1000), (33, 128, 1040)])
def test_bf16_x_plain_matches_jax_qmm_prefill(rng, interpret, rows, d, n):
    L = 2
    w = _gf4_stack(rng, L, d, n)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    for layer in range(L):
        got = hopper_qmm.qmm_prefill_plain(_bf16(x), torch.from_numpy(w), layer).numpy()
        pal = np.asarray(pallas_qmm.qmm_prefill(jnp.asarray(x), jnp.asarray(w),
                                                jnp.int32(layer)))
        np.testing.assert_allclose(got, pal, rtol=0, atol=1e-5 * np.abs(pal).max())


@pytest.mark.parametrize("rows,D,H", [(48, 256, 384), (40, 128, 1024)])
def test_bf16_x_plain_matches_jax_qmm_prefill_t(rng, interpret, rows, D, H):
    """K5: natural w2 words against the word-transposed layout the TPU
    kernel reads, h in k-major order there."""
    L = 2
    w2 = _gf4_stack(rng, L, D, H)
    h = rng.standard_normal((rows, H)).astype(np.float32)
    h_perm = h.reshape(rows, H // 8, 8).transpose(0, 2, 1).reshape(rows, H)
    wt = jnp.asarray(w2.transpose(0, 2, 1))
    for layer in range(L):
        got = hopper_qmm.qmm_prefill_w2(_bf16(h), torch.from_numpy(w2), layer).numpy()
        pal = np.asarray(pallas_qmm.qmm_prefill_t(jnp.asarray(h_perm), wt, jnp.int32(layer)))
        np.testing.assert_allclose(got, pal, rtol=0, atol=1e-5 * np.abs(pal).max())


def test_rounding_x_once_is_the_f32_products_rounding(rng):
    """The wrapper given f32 or the bf16 operand computes the same product
    on the plain path, and the operand is bf16 only where the kernel will
    read it: on the card and past 16 rows for gf4."""
    w = torch.from_numpy(_gf4_stack(rng, 1, 64, 256))
    x = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(hopper_qmm.qmm_prefill(xb, w, 0),
                               hopper_qmm.qmm_prefill(xb.float(), w, 0), rtol=0, atol=0)
    assert hopper_qmm.prefill_operand(x) is x            # the CPU keeps f32
    assert TM._mm_operand(x, QTensor(w, "gf4")) is x
    assert hopper_qmm.qmm_prefill.launches == 0 and hopper_qmm.qmm_prefill_w2.launches == 0
