"""The quality mode (``--precise``) at 2-16 rows on the port's multi-row
path, against calm_tpu on the CPU. The mode takes the default's launches
there: ``hopper_qmm.split_operand`` (x as hi and lo f16 terms under a
power of two per 64-value chunk, as ``csrc/qmm.cu``'s ``stage4`` stores
them) rebuilds x to 2^-22 of each chunk's scale, on chunks whose values
span 2^-30 of their max too; the product emulated as ``mmv_kernel``
computes it (the staged terms times the exact f16 weights, f64 sums a
chunk) against ``calm_tpu``'s ``--precise`` ``qmatmul`` for fp16, fp8,
fp8e4 and gf4 at B = 2, 8, 16 and a ragged (d, n); a product that lost
its lo term lands far past the limit ``chip_smoke.py`` holds the card's
float64 distance to; and on the CPU the wrapper is its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from calm_tpu import quant as jquant
from calm_tpu.ops import qmm as jqmm
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_CHUNK, split_operand

torch.set_num_threads(1)


def _scale(e: torch.Tensor, n: int) -> torch.Tensor:
    """2^e of each (row, chunk), spread over the chunk's values, float64."""
    return torch.ldexp(torch.ones((), dtype=torch.float64),
                       e.double()).repeat_interleave(MV_CHUNK, 1)[:, :n]


def _x(rng, B, n, span=False):
    """Seeded rows; with ``span`` every 64-value chunk's magnitudes run from
    its max down to 2^-30 of it (and rows differ by 2^20)."""
    x = rng.standard_normal((B, n)).astype(np.float32)
    if span:
        k = np.arange(n) % MV_CHUNK
        x = (np.sign(x) * (1 + rng.random((B, n))) * 2.0 ** -(30 * k / (MV_CHUNK - 1))
             ).astype(np.float32)
        x[1::2] *= 2.0 ** 20
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [16, 64, 1040, 4112])
@pytest.mark.parametrize("span", [False, True])
def test_two_terms_rebuild_x(rng, n, span):
    """hi + lo carry x to 2^-22 of its chunk's scale; both terms are
    finite f16 within [-1, 1]."""
    x = _x(rng, 8, n, span)
    hi, lo, e = split_operand(x)
    s = _scale(e, n)
    err = ((hi.double() + lo.double()) * s - x.double()).abs()
    assert (err <= 2.0 ** -22 * s).all()
    for t in (hi, lo):
        assert t.dtype == torch.float16 and torch.isfinite(t).all() and t.abs().max() <= 1


# -- the product, emulated as mmv_kernel computes it --------------------------------


def _weights(rng, fmt, d, n):
    """(the JAX package's QTensor, the port's weight, scale or None, the
    kernel's A operand in float64: every format's decode is exact in f16)."""
    a = (rng.standard_normal((d, n)) * 0.1).astype(np.float32)
    if fmt == "fp8e4":
        codes, s = jquant.fp8e4_quantize(a)
        qt = jqmm.QTensor(jnp.asarray(codes), fmt, jnp.asarray(s))
        w = torch.from_numpy(np.ascontiguousarray(codes).view(np.uint8)).view(
            torch.float8_e4m3fn)
        return qt, w, torch.from_numpy(s), w.to(torch.float16).double() * float(s[0])
    q = np.ascontiguousarray(jquant.quantize(a, fmt))
    qt = jqmm.QTensor(jnp.asarray(q), fmt)
    if fmt == "gf4":
        w = torch.from_numpy(q)
        return qt, w, None, hopper_qmm.gf4_f16_operand(w).double()
    w = (torch.from_numpy(q.view(np.uint8)).view(torch.float8_e5m2) if fmt == "fp8"
         else torch.from_numpy(q))
    return qt, w, None, w.to(torch.float16).double()


def _emulated(x: torch.Tensor, w64: torch.Tensor, lo: bool = True) -> torch.Tensor:
    """Per 64-value chunk: the hi and lo terms' products with the f16
    weights, exact, summed in float64, then times 2^e into the row's
    (fp8e4's scale is in w64: a power of two). ``lo=False``: a kernel that
    lost its lo term."""
    hi, lo_t, e = split_operand(x)
    parts = (hi, lo_t) if lo else (hi,)
    B, n = x.shape
    y = torch.zeros((B, w64.shape[0]), dtype=torch.float64)
    for c in range(e.shape[1]):
        ks = slice(c * MV_CHUNK, min(n, (c + 1) * MV_CHUNK))
        part = sum(t[:, ks].double() @ w64[:, ks].T for t in parts)
        y += part * torch.ldexp(torch.ones((), dtype=torch.float64), e[:, c].double())[:, None]
    return y


@pytest.fixture
def jax_precise():
    jqmm.enable_precise(True)
    yield
    jqmm.enable_precise(False)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "fp8e4", "gf4"])
@pytest.mark.parametrize("B,d,n,span", [(2, 64, 1024, False), (8, 96, 2048, True),
                                         (16, 48, 512, False), (9, 1003, 1040, True)])
def test_emulated_two_term_product_matches_jax(rng, jax_precise, fmt, B, d, n, span):
    """The two-term product against ``calm_tpu``'s ``--precise``
    ``qmatmul`` (its f32 product on the CPU) and against the exact product
    of x and the decoded weights: within 1e-6 of each row's max |out| of
    JAX (its own f32 sums are ~1e-7 to 1e-6 of that from the exact
    product), and within 2^-22 of sum |w| 2^e of the exact one; the port's
    plain version (what the CPU and ``chip_smoke.py`` hold the kernel to)
    within 1e-6 as well. (9, 1003, 1040): d not a multiple of a warp's 16
    or 32 rows, n not of 64, gf4's 130 words a row an even count; 1032
    below takes the odd one."""
    x = _x(rng, B, n, span)
    qt, w, s, w64 = _weights(rng, fmt, d, n)
    got = _emulated(x, w64)
    exact = x.double() @ w64.T
    want = torch.from_numpy(np.array(jqmm.qmatmul(jnp.asarray(x.numpy()), qt))).double()
    plain = hopper_qmm.qmm_decode(x, w, fmt, None, s).double()
    bound = w64.abs() @ _scale(split_operand(x)[-1], n).T  # (d, B): sum |w| 2^e
    assert ((got - exact).abs() <= 2.0 ** -22 * bound.T).all()
    for ref in (want, plain):
        tol = 1e-6 * ref.abs().amax(-1, keepdim=True)
        assert ((got - ref).abs() <= tol).all()


@pytest.mark.parametrize("B", [2, 16])
def test_emulated_gf4_odd_words(rng, jax_precise, B):
    """n = 1032: 129 words a row, the ODD instantiation's half-step."""
    x = _x(rng, B, 1032)
    qt, w, _, w64 = _weights(rng, "gf4", 40, 1032)
    got = _emulated(x, w64)
    want = torch.from_numpy(np.array(jqmm.qmatmul(jnp.asarray(x.numpy()), qt))).double()
    assert ((got - want).abs() <= 1e-6 * want.abs().amax(-1, keepdim=True)).all()


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "fp8e4", "gf4"])
def test_the_card_limit_sees_a_lost_lo_term(rng, fmt):
    """``chip_smoke.py`` holds the quality mode's distance from the float64
    product on the lm-head (each row to its max |y|) to PRECISE_F64_LIMIT.
    At that width (n = 4096, B = 8) a kernel that lost x's lo term lands
    over 100x past the limit (~2.7e-4), while hi + lo with exact sums read
    under a quarter of it (~9e-8): the rest of what the card reads is its
    f32 sums'."""
    x = _x(rng, 8, 4096)
    _, _, _, w64 = _weights(rng, fmt, 256, 4096)
    exact = x.double() @ w64.T

    def dist(y):
        return ((y - exact).abs().amax(-1) / exact.abs().amax(-1)).max().item()
    limit = chip_smoke.PRECISE_F64_LIMIT
    assert dist(_emulated(x, w64, lo=False)) > 100 * limit
    assert dist(_emulated(x, w64)) < limit / 4


def test_the_wrapper_on_the_cpu_is_the_plain_version(rng):
    """On the CPU the 2-16-row product is the plain f32 version, and no
    launch is counted."""
    x = _x(rng, 8, 256)
    _, w, _, _ = _weights(rng, "fp8", 64, 256)
    before = (hopper_qmm.qmm_decode.multirow_launches, hopper_qmm.qmm_decode.launches)
    got = hopper_qmm.qmm_decode(x, w, "fp8", None, None)
    assert torch.equal(got, hopper_qmm.qmm_decode_plain(x, w, "fp8"))
    assert (hopper_qmm.qmm_decode.multirow_launches, hopper_qmm.qmm_decode.launches) == before
