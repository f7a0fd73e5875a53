"""Quantized products on Hopper: the ports of pallas_qmm's kernels.

- :func:`qmm_decode` replaces ``_layered_qmm_kernel``
  (``calm_tpu/ops/pallas_qmm.py:92``): y = x . dequant(W[layer])^T for
  fp8/fp16 (``csrc/qmm.cu``), and for fp8e4, which JAX runs through XLA
  (``calm_tpu/ops/qmm.py:179-205``), times its scale; gf4 goes to
  :func:`qmm_decode_gf4`. From 2 rows of x it takes the multi-row path on
  the tensor cores, tiled by :func:`qmv_plan`, x staged as scaled f16 hi +
  lo (:func:`split_operand` writes the staging out in PyTorch), in the
  quality mode too (:func:`decode_path`); 17-64 rows, where JAX's XLA
  product runs (``calm_tpu/ops/qmm.py:189-205``), the wide path
  (``wide_kernel``: TMA and ``wgmma``, x staged once a launch with one
  scale a row in one f16 term and loaded once a stage for a whole block,
  tiled by :func:`wide_plan`; :func:`wide_operand` writes the staging out in
  PyTorch, :func:`wide_staged` its byte order; ``mmw_kernel`` under
  --precise, hi + lo, and for gf4 rows TMA cannot read, :func:`wide_tma`).
- :func:`qmm_decode_gf4` replaces ``_layered_gf4_kernel`` (``:100``): the
  same matvec on natural gf4 words, B <= 64: one row in ``csrc/gf4.cu``,
  from 2 rows on the multi-row path (``csrc/qmm.cu``), past 16 the wide
  one, in the quality mode too.
- :func:`qmm_prefill` replaces ``_gf4_mm_kernel`` (``:238``): the gf4
  product for R >= 32 rows (``csrc/gf4.cu``), eligibility as
  ``mm_supported`` (``:275-283``); x enters as bf16, rounded once by
  :func:`prefill_operand` as JAX rounds it before its ``pallas_call``.
- :func:`qmm_prefill_w2` replaces ``_gf4_mmt_kernel`` (``:346``): the
  FFN's w2 product at prefill. The TPU kernel reads word-transposed w2 for
  Mosaic; on natural words it is K4's product and launches K4's kernel.
- :func:`qmm_mm8` takes the fp16/fp8/fp8e4 products past 64 rows, which JAX
  runs in XLA (``calm_tpu/ops/qmm.py:189-205``: the plane widened to bf16,
  x cast to bf16, f32 sums, fp8e4 scaled after): the same arithmetic on TMA
  and ``wgmma`` (``csrc/mm.cu``), the weights read in their stored bytes
  and widened on chip, x rounded once to bf16 by :func:`prefill_operand`,
  tiled by :func:`mm8_plan` (token tiles of up to 256 rows, k split in a
  cluster where that fills the card's waves better).
- :func:`qx_offn_qkv` replaces ``_qx_offn_qkv_kernel`` (``:942``): one
  layer's wo + residual, ffn-norm, w1/w3 + activation, w2 + residual and
  the next layer's attn-norm + q/k/v (``csrc/qmm.cu``).
- :func:`gf4_offn_qkv` replaces ``_gf4_offn_qkv_kernel`` (``:737``): the
  same epilogue on natural gf4 words (``csrc/qmm.cu``, fmt 2), where the
  TPU kernel reads plane-permuted layouts; one row on the one-row gf4
  kernel, several rows a warp and k split on the narrow launches as
  :func:`gf4_row_plan` tiles them; from 2 rows on the multi-row path, the
  words decoded exactly to f16 (:func:`gf4_f16_operand` writes the decode
  out). :func:`gf4_ffn` and :func:`gf4_offn` take the same two paths.
- :func:`gf4_ffn` replaces ``_gf4_ffn_kernel`` (``:464``): the gf4 FFN
  alone, w2 . (act(w1 . x) * (w3 . x)), which parallel-norm (Cohere)
  decode runs on the attn-normed input (``csrc/qmm.cu``; from 2 rows on
  the multi-row path), where the TPU kernel reads plane-major w1/w3 and
  word-transposed w2.
- :func:`gf4_offn` replaces ``_gf4_offn_kernel`` (``:601``): wo +
  residual, ffn-norm and the FFN, returning the FFN and r1 apart (the
  ``CALM_ROT=0`` decode; ``csrc/qmm.cu``; from 2 rows on the multi-row
  path), in natural order where the TPU kernel runs on a plane-permuted
  residual stream.
- :func:`qmm_moe_dense` replaces ``_moe_dense_kernel`` and
  ``_moe_dense_gf4_kernel`` (``:1248``, ``:1256``): the MoE expert sweep,
  one matvec per expert slot with the ids on the device: one row in
  ``csrc/moe.cu``, from 2 rows on the multi-row path (``csrc/qmm.cu``,
  an expert-slot axis, tiled by :func:`qmv_plan` with ``slots``; 17-64
  rows the wide path), where :func:`moe_multirow_supported` takes the
  shape, else ``csrc/moe.cu``.
- :func:`qmm_moe_ffn`: the same kernels' three fp16/fp8/fp8e4 products of
  the expert FFN and their activation (``calm_tpu/model.py:810-816``) at
  2-64 rows, as two products on the multi-row path (``csrc/qmm.cu``: x
  staged, the dual w1/w3 launch, h staged a slot at a time, w2; past 16
  rows on the wide path, where JAX runs its per-token vmap,
  ``calm_tpu/model.py:829-857``).

fp8e4 weights carry their scale as a device tensor, (L, 1) beside a
stack, (L, E, 1) beside an expert stack: the wrappers pass the address
of the layer's entry (:func:`_scale_ptr`) and the kernels read it there,
plus the slot's expert id, so no scale comes to the host and a captured
step replays them; each product's sum is scaled before any activation.
- :func:`gf4_moe_ffn` replaces ``_gf4_moe_ffn_kernel`` (``:1361``): each
  slot's whole expert FFN on natural gf4 words, where the TPU kernel
  reads plane-major w1/w3: one row in ``csrc/moe.cu``, from 2 rows (to
  64) the chain of :func:`qmm_moe_ffn` (``csrc/qmm.cu``).

Each wrapper takes its plain PyTorch version (``*_plain``, f32) for tensors
on the CPU, and launches the kernel for CUDA tensors or raises; it counts
its launches in ``.launches`` (:func:`qmm_decode`, :func:`qmm_decode_gf4`,
:func:`qx_offn_qkv`, :func:`gf4_offn_qkv`, :func:`gf4_ffn`,
:func:`gf4_offn`, :func:`qmm_moe_dense`, :func:`qmm_moe_ffn` and
:func:`gf4_moe_ffn` those of the multi-row path also in
``.multirow_launches``; :func:`qmm_decode`, :func:`qmm_decode_gf4` and
the MoE sweep's those of the wide path, 17-64 rows, in
``.wide_launches``). ``MAX_ROWS`` (16) stays the limit of the fused
epilogues K6-K9, as their JAX domain (``pallas_qmm.py:1236``);
``MAX_MV_ROWS`` (64) is that of the products and the expert sweep.
:func:`qmm_mm8` counts the rows it takes in ``cost.count("qmm.mm8_rows")``
(on the CPU they go to ``dense_matmul``'s plain product, counted there). While
a profiler trace is open each launch's bytes and operations are recorded,
in the order the C entry points launch their kernels (``ops/cost.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from calm_tpu_torch.ops import build, cost
from calm_tpu_torch.ops import qmm as _qmm
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import STORAGE, QTensor, dense_matmul, dequant

_FMT_CODE = {"fp16": 0, "fp8": 1, "fp8e4": 3}  # qmm_decode, qmm_moe_ffn
_OFFN_CODE = dict(_FMT_CODE, gf4=2)  # csrc/qmm.cu's products, csrc/moe.cu
_EPILOGUE_FMTS = ("fp16", "fp8")  # qx_offn_qkv: fp8e4 decodes per op, as in JAX
MAX_ROWS = 16  # the fused epilogues (K6-K9), as pallas_qmm.py:1236, and mmv_kernel
MAX_MV_ROWS = 64  # the products and the MoE sweep: 17-64 rows on the wide path
MIN_MM_ROWS = 32  # qmm_prefill's least row count (pallas_qmm.mm_supported)
MAX_NORM_DIM = 16384  # norm_kernel: 1024 threads x 4 float4 in registers
SMS = 132  # an H100's streaming multiprocessors
# the multi-row path (csrc/qmm.cu mmv_kernel)
MV_CHUNK = 64  # CH: k values a chunk, one x scale per (row, chunk)
MV_WARPS = 8  # WARPS: warps a block
MV_TARGET_WARPS = 16 * SMS  # about 16 warps' loads in flight an SM
MV_MIN_CHUNKS = 4  # the least chunks a warp's share of k, where k allows
MV_MT2_ROWS = 6144  # from this many rows a launch, 32 rows a warp (else 16)
# the wide path (17-64 rows) on TMA and wgmma (csrc/qmm.cu wide_kernel): x in
# one f16 term, every format whose weight rows TMA reads
WIDE_K = 128  # k values a stage (WT_K); the staging permutes k within each 128
WIDE_WIDTHS = (32, 40, 64)  # the compiled widths N a launch rounds its rows of x up to
WIDE_TILE = 128  # output rows a block: two warpgroups of 64 (the dual launch: 64 of both)
WIDE_ROWS = 64  # row slots of a staging, one scale each
WIDE_MAX_KS = 8  # k parts a tile at most: the blocks of one cluster
# the k split until a launch has a block an SM: more blocks (two fit an SM)
# timed slower at every shape of a Mistral-7B verify on an H100 (PERF.md)
WIDE_TARGET_BLOCKS = SMS
WIDE_MIN_STAGES = 4  # the least stages a k part keeps, where k allows
# the wide path of --precise (x in hi + lo) and of gf4 rows TMA cannot read
# (n % 32 != 0): mmw_kernel, mma.sync
WIDE_NT = 8  # 8-row n-tiles a warp holds (csrc/qmm.cu WIDE_NT); those past B skipped
WIDE_PREC_ROWS = 32  # --precise: rows of x a launch (csrc/qmm.cu WIDE_PREC_ROWS)
# its k split: about 8 warps an SM, the one block of mmw_kernel that its
# registers allow (2112 and 4224 timed slower on an H100, PERF.md)
WIDE_TARGET_WARPS = 8 * SMS
# products past 64 rows of fp16/fp8/fp8e4 on TMA and wgmma (csrc/mm.cu mm8_kernel)
MM8_K = 64  # k values a stage (MM_K)
MM8_ROWS = 128  # weight rows a block: two warpgroups of 64 (MM_ROWS)
MM8_WIDTHS = (128, 192, 256)  # the compiled token tiles N; one tile covers R <= 256
MM8_MAX_KS = 8  # k parts a tile at most: the blocks of a portable cluster (MM_KS)
MM8_MIN_STAGES = 4  # the least stages a k part keeps, where k allows
MM8_FEW_UNITS = 16  # row x token tiles up to which k splits in MM8_MAX_KS parts
MM8_WAVE_GAIN = 0.1  # how much fuller two parts must fill the waves to split k
# the one-row gf4 path (csrc/qmm.cu gf4_row_kernel)
G1_ROWS = 4  # output rows a warp, fixed in the kernel (csrc/qmm.cu G1_ROWS)
G1_ROWS_DUAL = 2  # the same for the dual w1/w3 launch (two weights a row)
G1_TARGET_WARPS = MV_TARGET_WARPS  # split k until about this many warps
G1_MIN_WORDS = 128  # the least words of a warp's share of k: 4 a lane


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(fmt: str, x: torch.Tensor, weights) -> None:
    _check(fmt in _OFFN_CODE, f"no CUDA kernel for weight format {fmt!r}")
    _check(x.dtype == torch.float32 and x.is_contiguous(),
           "activations must be contiguous float32")
    _check(x.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    for w in weights:
        _check(w.device == x.device, "weights and activations on different devices")
        _check(w.dtype == STORAGE[fmt], f"{fmt} weights must be {STORAGE[fmt]}")
        _check(w.is_contiguous(), "weights must be contiguous")
        _check(w.shape[-1] % 16 == 0, "contraction dim must be a multiple of 16")


def _plane_ptr(w: torch.Tensor, layer: int) -> int:
    """Address of the contiguous plane w[layer], without building a view
    (the fused epilogue takes nine of them per layer and token)."""
    return w.data_ptr() + layer * w.stride(0) * w.element_size()


def _plane(w: torch.Tensor, layer) -> torch.Tensor:
    if w.ndim == 2:
        return w
    _check(layer is not None and 0 <= int(layer) < w.shape[0],
           f"layer {layer} out of range for a stack of {w.shape[0]}")
    return w[int(layer)]


def _scale_ptr(fmt: str, scale, w: torch.Tensor, layer, x: torch.Tensor,
               experts: bool = False) -> int | None:
    """The device address of the fp8e4 scale of plane ``layer`` of w:
    scale (L, 1) beside a stack w (L, d, n), (1,) beside one plane (d, n),
    (L, E, 1) beside an expert stack (L, E, d, n), where the kernel adds
    the expert id of its slot. The value stays on the device (the kernel
    reads it; a captured step replays it); other formats take none."""
    if fmt != "fp8e4":
        _check(scale is None, f"{fmt} weights take no scale")
        return None
    _check(scale is not None, "fp8e4 weights need their scale")
    _check(scale.dtype == torch.float32 and scale.is_contiguous()
           and scale.device == x.device, "the fp8e4 scale must be contiguous float32 "
           "on the activations' device")
    lead = tuple(w.shape[:-2])
    _check(tuple(scale.shape) == (lead + (1,) if lead else (1,)),
           f"the fp8e4 scale of a weight {tuple(w.shape)} must be "
           f"{lead + (1,) if lead else (1,)}, got {tuple(scale.shape)}")
    if w.ndim == (3 if experts else 2):
        return scale.data_ptr()
    return scale.data_ptr() + int(layer) * scale.stride(0) * 4


def _scaled(y: torch.Tensor, scale, layer) -> torch.Tensor:
    """A plain product times plane ``layer``'s fp8e4 scale (a stack's (L,
    1) or one plane's (1,)), as ``calm_tpu/ops/qmm.py:185-205`` scales the
    output; y as it is without one."""
    if scale is None:
        return y
    return y * (scale if scale.ndim == 1 else scale[int(layer)]).to(y.device)


# ---------------------------------------------------------------------------
# The multi-row path's tiling and staging (csrc/qmm.cu mmv_kernel)
# ---------------------------------------------------------------------------


class QmvPlan(NamedTuple):
    """One multi-row launch's tiling: ``ks`` warps split the k of each
    group of ``16 mt`` output rows (a warp holds ``mt`` 16-row m-tiles),
    ``MV_WARPS / ks`` groups a block; ``nt`` 8-row n-tiles of x."""
    mt: int          # 16-row m-tiles a warp (1 or 2)
    nt: int          # 8-row n-tiles of x (1 for B <= 8, 2 to 16 rows; past 16 WIDE_NT,
                     # under --precise WIDE_PREC_ROWS / 8)
    ks: int          # warps a row group (1, 2, 4 or 8)
    grid: int        # blocks
    groups: tuple    # row groups of each segment
    chunks: int      # MV_CHUNK-value chunks of k (the last one may be short)
    slots: int = 1   # MoE expert slots: the grid's second axis, each slot's rows
                     # and k tiled alike

    def args(self) -> tuple[int, int, int, int]:
        """What the kernel's launcher takes: {mt, nt, ks, grid}; ``grid``
        blocks a slot."""
        return (self.mt, self.nt, self.ks, self.grid)

    def warp_work(self, block: int, warp: int, seg_rows) -> tuple | None:
        """(segment, first row, end row, first chunk, end chunk) of warp
        ``warp`` of block ``block``, as the kernel computes it; None for a
        warp past the last group. Its rows are clipped to the segment."""
        return _warp_work(block, warp, self.ks, 16 * self.mt, self.groups, seg_rows,
                          self.chunks)

    def staging(self, n: int, terms: int = 1) -> tuple[int, int]:
        """(int32 words of xs, floats of sc) the staged x of n values a row
        takes: at 2-16 rows a 16-byte fragment (hi + lo) and one scale per
        (chunk, row slot) and step, 8 nt row slots; on the wide path an
        8-byte fragment a term (``terms``: 1, or 2 under --precise) per
        (chunk, step, row slot), 8 WIDE_NT row slots, one scale a row."""
        nc = -(-n // MV_CHUNK)
        if self.nt > 2:  # the wide path
            return nc * 4 * 8 * WIDE_NT * 4 * 2 * terms, 8 * WIDE_NT
        return nc * 4 * 8 * self.nt * 4 * 4, nc * 8 * self.nt


def wide_tma(n: int, gf4: bool, terms: int = 1) -> bool:
    """Whether a wide launch (17-64 rows) of k = n takes ``wide_kernel``
    (TMA + wgmma): x in one f16 term and weight rows of 16-byte multiples
    (gf4 words: n % 32 == 0); else ``mmw_kernel`` (``csrc/qmm.cu``
    ``wide_tma``)."""
    return terms == 1 and (not gf4 or n % 32 == 0)


def _npad(n: int) -> int:
    return -(-n // WIDE_K) * WIDE_K


class WidePlan(NamedTuple):
    """One launch of ``wide_kernel``: blocks of ``tile`` output rows (128
    of one weight, two warpgroups of 64; the dual w1/w3 launch 64 rows of
    both), every row of x at the compiled ``width``, the k of a tile split
    into ``ks`` parts, the ``ks`` consecutive blocks of one cluster, which
    add their partial sums in rank order (part 0 first) through distributed
    shared memory, each for its share of x's rows."""
    width: int     # N, the compiled width (WIDE_WIDTHS) >= B
    ks: int        # k parts a tile (1, 2, 4 or 8)
    tiles: int     # row tiles (a slot)
    stages: int    # WIDE_K-value stages of k
    tile: int      # output rows a block (WIDE_TILE, 64 for the dual launch)
    B: int         # rows of x
    slots: int = 1

    @property
    def grid(self) -> int:
        """Blocks a slot: tiles x k parts, the parts of a tile adjacent."""
        return self.tiles * self.ks

    def args(self) -> tuple[int, int, int, int]:
        """What the kernel's launcher takes: {tile / 16, width / 8, ks,
        grid}."""
        return (self.tile // 16, self.width // 8, self.ks, self.grid)

    def block_work(self, block: int, rows: int) -> tuple[int, int, int, int, int, int]:
        """(first row, end row, first stage, end stage, first x row, end x
        row) of block ``block`` as the kernel computes it: tile block // ks
        (its rows clipped to ``rows``), k part block % ks, which stores the
        tile's outputs of x rows [part B / ks, (part + 1) B / ks)."""
        t, kp = divmod(block, self.ks)
        return (t * self.tile, min((t + 1) * self.tile, rows), kp * self.stages // self.ks,
                (kp + 1) * self.stages // self.ks, kp * self.B // self.ks,
                (kp + 1) * self.B // self.ks)

    def staging(self, n: int, terms: int = 1) -> tuple[int, int]:
        """(int32 words, floats) of the staged x of n values a row: WIDE_ROWS
        rows of f16 (n rounded up to WIDE_K), one scale a row."""
        return WIDE_ROWS * _npad(n) // 2, WIDE_ROWS


def wide_plan(B: int, rows: int, n: int, dual: bool = False, slots: int = 1) -> WidePlan:
    """``wide_kernel``'s tiling of one launch: B rows of x (17..64, the
    wide path's), ``rows`` output rows of each weight, k = n (a positive
    multiple of 16), ``dual`` for the w1/w3 launch, ``slots`` expert slots
    (each tiled alike): the narrowest compiled width >= B, tiles of
    WIDE_TILE rows (64 for the dual launch), the k of a tile split in two
    while the launch keeps to WIDE_TARGET_BLOCKS blocks and each part
    WIDE_MIN_STAGES stages, up to WIDE_MAX_KS."""
    _check(MAX_ROWS < B <= MAX_MV_ROWS,
           f"the wide kernel takes {MAX_ROWS + 1}..{MAX_MV_ROWS} rows, not {B}")
    _check(rows >= 1 and n >= 16 and n % 16 == 0 and 1 <= slots <= 65535,
           f"rows >= 1, k a positive multiple of 16 and 1..65535 slots, not {rows}, {n}, "
           f"{slots}")
    return _wide_plan(int(B), int(rows), int(n), bool(dual), int(slots))


def _wide_plan(B: int, rows: int, n: int, dual: bool, slots: int) -> WidePlan:
    width = next(w for w in WIDE_WIDTHS if w >= B)
    tile = WIDE_TILE // 2 if dual else WIDE_TILE
    tiles, stages = -(-rows // tile), -(-n // WIDE_K)
    ks = 1
    while (ks < WIDE_MAX_KS and tiles * 2 * ks * slots <= WIDE_TARGET_BLOCKS
           and stages // (2 * ks) >= WIDE_MIN_STAGES):
        ks *= 2
    return WidePlan(width, ks, tiles, stages, tile, B, slots)


def _warp_work(block: int, warp: int, ks: int, gr: int, groups, seg_rows, units: int):
    """The kernels' split of work: ``ks`` warps a group of ``gr`` rows,
    ``MV_WARPS / ks`` groups a block, the groups of segment 0, then 1, then
    2; warp kw of a group takes units [kw units / ks, (kw + 1) units / ks)
    of k."""
    grp = block * (MV_WARPS // ks) + warp // ks
    kw = warp % ks
    for s, (g, rows) in enumerate(zip(groups, seg_rows)):
        if grp < g:
            r0 = grp * gr
            return (s, r0, min(r0 + gr, rows), kw * units // ks, (kw + 1) * units // ks)
        grp -= g
    return None


def _k_split(groups: int, units: int, target: int, least: int) -> int:
    """Warps a row group splits k over: doubled while the launch has
    fewer than ``target`` warps and each share keeps ``least`` units of k,
    up to MV_WARPS."""
    ks = 1
    while ks < MV_WARPS and groups * ks < target and units // (2 * ks) >= least:
        ks *= 2
    return ks


@functools.lru_cache(maxsize=256)
def _qmv_plan(B: int, seg_rows: tuple, n: int, dual: bool, gf4: bool, slots: int,
              terms: int) -> QmvPlan | WidePlan:
    wide = B > MAX_ROWS
    if wide and wide_tma(n, gf4, terms):
        return _wide_plan(B, seg_rows[0], n, dual, slots)
    if wide:
        nt = WIDE_NT if terms == 1 else WIDE_PREC_ROWS // 8
    else:
        nt = 1 if B <= 8 else 2
    # gf4 rows that end half-way through a lane's 16 values: one m-tile a
    # warp; the wide path two for one weight's launches (x's reads halve),
    # one under --precise (its second set of sums)
    mt = (2 if (wide and terms == 1 or not wide and sum(seg_rows) >= MV_MT2_ROWS)
          and not dual and n % 16 == 0 else 1)
    groups = tuple(-(-r // (16 * mt)) for r in seg_rows)
    chunks = -(-n // MV_CHUNK)
    G = sum(groups)
    ks = _k_split(G * slots, chunks, WIDE_TARGET_WARPS if wide else MV_TARGET_WARPS,
                  MV_MIN_CHUNKS)
    grid = -(-G // (MV_WARPS // ks))
    return QmvPlan(mt, nt, ks, grid, groups, chunks, slots)


def qmv_plan(B: int, seg_rows, n: int, dual: bool = False, gf4: bool = False,
             slots: int = 1, terms: int = 1) -> QmvPlan | WidePlan:
    """The multi-row kernels' tiling of B rows of x (1..64; the kernels
    take it from 2, one row keeps the loop of one row; past 16 rows the
    wide path, one segment: a :class:`WidePlan` for ``wide_kernel`` where
    :func:`wide_tma` takes k, the k of a tile split in two while the launch
    keeps to WIDE_TARGET_BLOCKS blocks and each part WIDE_MIN_STAGES stages,
    up to WIDE_MAX_KS; else ``mmw_kernel``'s, WIDE_NT n-tiles, 32 rows a
    warp for one weight's launches of whole 16-value steps, else 16) against
    segments of
    ``seg_rows`` output rows each (1-3: q/k/v side by side) and k = n (a
    multiple of 16; of 8 for ``gf4`` words, whose rows may end half-way
    through a lane's 16 values), ``dual`` for the w1/w3 launch (two
    weights): 32 rows a warp for one weight's launches of MV_MT2_ROWS rows
    or more, else 16 (more row groups for the narrow wo and w2; the dual
    launch's lanes already stream two weights, and 32 rows of both timed
    slower on the card; rows that end half-way keep 16); k split in two
    until about MV_TARGET_WARPS warps fill the card, while each keeps
    MV_MIN_CHUNKS chunks or more, up to MV_WARPS. gf4 words take the same
    tiling: a re-sweep of these constants on them timed no better. The MoE
    sweep's ``slots`` expert slots (one segment) repeat the tiling a slot:
    the warps that fill the card are counted over slots x row groups.
    ``terms`` 2 (--precise) past 16 rows: WIDE_PREC_ROWS / 8 n-tiles and
    one m-tile, the kernel launched once for each WIDE_PREC_ROWS rows."""
    seg_rows = tuple(int(r) for r in seg_rows)
    _check(1 <= B <= MAX_MV_ROWS, f"the multi-row path takes 1..{MAX_MV_ROWS} rows, not {B}")
    _check(1 <= len(seg_rows) <= 3 and all(r >= 1 for r in seg_rows),
           f"1-3 segments of >= 1 row, not {seg_rows}")
    step = 8 if gf4 else 16
    _check(n >= step and n % step == 0, f"k must be a positive multiple of {step}, not {n}")
    _check(1 <= slots <= 65535 and (slots == 1 or len(seg_rows) == 1),
           f"1..65535 slots of one segment, not {slots} of {len(seg_rows)}")
    _check(terms in (1, 2), f"x takes 1 or 2 f16 terms, not {terms}")
    _check(B <= MAX_ROWS or len(seg_rows) == 1,
           f"past {MAX_ROWS} rows a launch takes one segment, not {len(seg_rows)}")
    return _qmv_plan(int(B), seg_rows, int(n), bool(dual), bool(gf4), int(slots),
                     int(terms) if B > MAX_ROWS else 1)


@functools.lru_cache(maxsize=256)
def _launch_plans(B: int, launches: tuple, gf4: bool = False,
                  terms: int = 1) -> tuple[np.ndarray, int, int]:
    """For the launches ``((seg_rows, n, dual), ...)`` of one call at B
    rows (k = n in values, on ``gf4`` words or not; x in ``terms`` f16
    terms on the wide path): their plans' kernel arguments in one int32
    array, and the words and floats of the staging scratch they share
    (sized for the largest n)."""
    ps = [qmv_plan(B, rows, n, dual, gf4, terms=terms) for rows, n, dual in launches]
    words, floats = ps[0].staging(max(n for _, n, _ in launches), terms)
    return np.array([v for p in ps for v in p.args()], dtype=np.int32), words, floats


# ---------------------------------------------------------------------------
# The one-row gf4 path's tiling (csrc/qmm.cu gf4_row_kernel)
# ---------------------------------------------------------------------------


class RowPlan(NamedTuple):
    """One launch of the one-row gf4 kernel: ``rows`` output rows a warp
    (the kernel's own), ``ks`` warps split the words of each row group into
    contiguous ranges, ``MV_WARPS / ks`` groups a block."""
    rows: int        # output rows a warp (G1_ROWS, G1_ROWS_DUAL for the dual launch)
    ks: int          # warps a row group (1, 2, 4 or 8)
    grid: int        # blocks
    groups: tuple    # row groups of each segment
    words: int       # gf4 words of k (n / 8)

    def args(self) -> tuple[int, int]:
        """What the kernel's launcher takes: {ks, grid}."""
        return (self.ks, self.grid)

    def warp_work(self, block: int, warp: int, seg_rows) -> tuple | None:
        """(segment, first row, end row, first word, end word) of warp
        ``warp`` of block ``block``, as the kernel computes it; None for a
        warp past the last group. Its rows are clipped to the segment."""
        return _warp_work(block, warp, self.ks, self.rows, self.groups, seg_rows, self.words)


@functools.lru_cache(maxsize=256)
def _gf4_row_plan(seg_rows: tuple, n: int, dual: bool) -> RowPlan:
    R = G1_ROWS_DUAL if dual else G1_ROWS
    groups = tuple(-(-r // R) for r in seg_rows)
    words = n // 8
    G = sum(groups)
    ks = _k_split(G, words, G1_TARGET_WARPS, G1_MIN_WORDS)
    return RowPlan(R, ks, -(-G // (MV_WARPS // ks)), groups, words)


def gf4_row_plan(seg_rows, n: int, dual: bool = False) -> RowPlan:
    """The one-row gf4 kernel's tiling of one row of x against segments of
    ``seg_rows`` output rows each (1-3: q/k/v side by side) and k = n (a
    positive multiple of 8: whole words), ``dual`` for the w1/w3 launch:
    the kernel's G1_ROWS rows a warp (G1_ROWS_DUAL for the dual launch), so
    one load of x serves them all; the words of k split in two until about
    G1_TARGET_WARPS warps fill the card, while each keeps G1_MIN_WORDS
    words or more, up to MV_WARPS."""
    seg_rows = tuple(int(r) for r in seg_rows)
    _check(1 <= len(seg_rows) <= 3 and all(r >= 1 for r in seg_rows),
           f"1-3 segments of >= 1 row, not {seg_rows}")
    _check(n >= 8 and n % 8 == 0, f"k must be a positive multiple of 8, not {n}")
    return _gf4_row_plan(seg_rows, int(n), bool(dual))


@functools.lru_cache(maxsize=256)
def _row_plans(launches: tuple) -> np.ndarray:
    """The one-row gf4 plans of the launches ``((seg_rows, n, dual), ...)``
    of one call, in one int32 array (the kernel's launcher reads two ints
    a launch)."""
    return np.array([v for rows, n, dual in launches for v in gf4_row_plan(rows, n, dual).args()],
                    dtype=np.int32)


def split_operand(x: torch.Tensor, chunk: int = MV_CHUNK):
    """The multi-row kernel's staging of x (B, n), written out in PyTorch
    in natural order (the kernel stores the same values permuted within
    each chunk): per (row, chunk) e with max |x| < 2^e (0 for a chunk of
    zeros), hi = f16(x 2^-e), lo = f16(x 2^-e - hi). Returns (hi, lo) (B, n)
    float16 and e (B, n / chunk up) int32; x ~ (hi + lo) 2^e to 2^-22 of
    2^e. Used by the tests, not on the main path."""
    B, n = x.shape
    nc = -(-n // chunk)
    xp = torch.zeros((B, nc * chunk), dtype=torch.float32, device=x.device)
    xp[:, :n] = x.float()
    xc = xp.reshape(B, nc, chunk)
    _, e = torch.frexp(xc.abs().amax(-1))
    e = e.to(torch.int32)
    v = torch.ldexp(xc, -e[..., None].float())
    hi = v.half()
    lo = (v - hi.float()).half()
    return (hi.reshape(B, -1)[:, :n], lo.reshape(B, -1)[:, :n], e)


def gf4_f16_operand(words: torch.Tensor) -> torch.Tensor:
    """The multi-row kernel's decode of gf4 words (..., g) int32 to its f16
    A operand (..., 8 g), written out in PyTorch: the scale byte placed in
    the high byte of an f16 (the same e5m2 value); codes 4h and 4h + 1 of
    each half-word h under the mantissa of 1024 at bit 0 (less 1028: c - 4,
    times e / -4), codes 4h + 2 and 4h + 3 at bit 6 (less 1280: 64 (c - 4),
    times e / -256), every step in f16 and exact. Used by the tests, not on
    the main path."""
    w = words.to(torch.int32)
    eb = (w & 0xFF) << 8
    e = torch.where(eb >= 0x8000, eb - 0x10000, eb).to(torch.int16).view(torch.float16)
    out = []
    for k in range(8):
        c = (w >> (8 + 3 * k)) & 7
        shift, base, mul = (0, 1028.0, -0.25) if k % 4 < 2 else (6, 1280.0, -1 / 256)
        v = (0x6400 | (c << shift)).to(torch.int16).view(torch.float16)
        out.append((v - torch.tensor(base, dtype=torch.float16))
                   * (e * torch.tensor(mul, dtype=torch.float16)))
    return torch.stack(out, -1).reshape(*w.shape[:-1], w.shape[-1] * 8)


def wide_perm() -> np.ndarray:
    """``wide_kernel``'s order of k within each WIDE_K-value stage: position
    p = 16 s + slot of the staging holds the stage's value 32 t + 4 s + j,
    slot 2 t + j (j < 2) or 8 + 2 t + j - 2: the k of A fragment slot ``slot``
    at step s, whose weights lane t of a quad reads as 32 contiguous values
    (``csrc/qmm.cu`` ``wt_load``, ``wt_frag``). Returns k of each p."""
    k = np.arange(WIDE_K)
    t, s, j = k >> 5, (k >> 2) & 7, k & 3
    p = 16 * s + np.where(j < 2, 2 * t + j, 6 + 2 * t + j)
    out = np.empty(WIDE_K, np.int64)
    out[p] = k
    return out


def wide_staged(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``stage_wide_kernel``'s staging of x (B, n), written out in PyTorch:
    (B, n rounded up to WIDE_K) float16, each row's hi = f16(x 2^-e) (zeros
    past n) with k permuted within each stage by :func:`wide_perm`, and e
    (B,) int32 with max |x| < 2^e (0 for a row of zeros). Used by the
    tests, not on the main path."""
    B, n = x.shape
    hi, _, e = wide_operand(x, 1)
    pad = torch.zeros((B, _npad(n)), dtype=torch.float16)
    pad[:, :n] = hi
    k = torch.from_numpy(wide_perm())
    nb = _npad(n) // WIDE_K
    idx = (torch.arange(nb)[:, None] * WIDE_K + k[None, :]).reshape(-1)
    return pad[:, idx], e


def wide_operand(x: torch.Tensor, terms: int = 1):
    """The wide path's staging of x (B, n), written out in PyTorch in
    natural order: per row e with max |x| < 2^e (0 for a row of zeros), hi
    = f16(x 2^-e), and under ``terms`` 2 lo = f16(x 2^-e - hi). Returns (hi,
    lo or None) (B, n) float16 and e (B,) int32; the kernel's product is
    sum_k w_k (hi + lo)_k 2^e with f32 sums. Used by the tests, not on the
    main path."""
    xf = x.float()
    _, e = torch.frexp(xf.abs().amax(-1))
    e = e.to(torch.int32)
    v = torch.ldexp(xf, -e[:, None].float())
    hi = v.half()
    lo = (v - hi.float()).half() if terms == 2 else None
    return hi, lo, e


def x_terms() -> int:
    """x's f16 terms on the wide path: 2 under --precise (hi + lo, as
    every 2-16-row product), else 1."""
    return 2 if _qmm._PRECISE else 1


def _staging(words: int, floats: int, dev) -> tuple[torch.Tensor, int, int]:
    """One scratch buffer for the staged x: (buffer, address of the
    fragments, address of the scales after them)."""
    buf = torch.empty(words + floats, dtype=torch.int32, device=dev)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * words


# ---------------------------------------------------------------------------
# launch costs, recorded while a profiler trace is open (ops/cost.py), in
# the order csrc/qmm.cu, gf4.cu and moe.cu launch their kernels
# ---------------------------------------------------------------------------

_WBYTES = {"fp16": 2.0, "fp8": 1.0, "fp8e4": 1.0, "gf4": 0.5}  # bytes a weight


def _cost_mv(kernel: str, fmt: str, B: int, rows: int, n: int, dual: bool = False,
             resid: bool = False, slots=1) -> None:
    """A product's launch: rows x n weights (two planes for the dual w1/w3
    launch), x (B, n) f32 read, y (B, rows) f32 written and the residual
    read, for each of ``slots`` expert slots (an int, or a function giving
    the live ones once the trace ends)."""
    k = 2 if dual else 1
    nbytes = rows * n * _WBYTES[fmt] * k + 4 * B * (n + rows * (2 if resid else 1))
    ops = 2 * B * rows * n * k
    if callable(slots):
        cost.record(kernel, lambda: slots() * nbytes, lambda: slots() * ops)
    else:
        cost.record(kernel, slots * nbytes, slots * ops)


def _cost_pass(kernel: str, values: int, extra: int = 0) -> None:
    """An elementwise launch over f32 values (the norm, x staged): each
    read and written once, ``extra`` bytes besides (the norm's weights)."""
    cost.record(kernel, 8 * values + extra, values)


def _wide_launches(B: int) -> list[int]:
    """The rows of x of each launch of ``mmw_kernel`` at B rows: one, or
    under --precise one for each WIDE_PREC_ROWS (each reads the weights)."""
    step = WIDE_PREC_ROWS if x_terms() == 2 else B
    return [min(step, B - b0) for b0 in range(0, B, step)]


def _cost_wide(fmt: str, B: int, d: int, n: int, dual: bool = False, slots=1,
               copies: int = 1) -> None:
    """A wide product's launches: x staged (``copies`` stagings: 1, or one
    a slot), then ``wide_kernel``, or ``mmw_kernel`` (once, or under
    --precise once for each WIDE_PREC_ROWS rows of x)."""
    tma = wide_tma(n, fmt == "gf4", x_terms())
    _cost_pass("stage_wide_kernel" if tma else "split_rows_kernel", copies * B * n)
    for b in [B] if tma else _wide_launches(B):
        _cost_mv("wide_kernel" if tma else "mmw_kernel", fmt, b, d, n, dual=dual, slots=slots)


def _cost_path(path: str, fmt: str, B: int, d: int, n: int, one_row: str) -> None:
    """A product's launches by :func:`decode_path`: x staged, then the
    multi-row or wide kernel; one row ``one_row`` alone."""
    if path == "one-row":
        _cost_mv(one_row, fmt, B, d, n)
    elif path == "wide":
        _cost_wide(fmt, B, d, n)
    else:
        _cost_pass("split_kernel", B * n)
        _cost_mv("mmv_kernel", fmt, B, d, n)


def _cost_epilogue(fmt: str, B: int, D: int, H: int, Qd: int = 0, qkv: int = 0,
                   resid2: bool = False) -> None:
    """The launches of the epilogue chains (K6-K9): with ``Qd``, wo +
    residual and the ffn-norm; the FFN (w2 with the residual under
    ``resid2``); with ``qkv`` rows, the attn-norm and the next layer's
    q/k/v. From 2 rows each product's x is staged first (by a split
    launch, or by the norm launch before it)."""
    if not cost.active():
        return
    mr = B >= 2
    k = "mmv_kernel" if mr else "gf4_row_kernel" if fmt == "gf4" else "qmv_kernel"
    if Qd:
        if mr:
            _cost_pass("split_kernel", B * Qd)
        _cost_mv(k, fmt, B, D, Qd, resid=True)
        _cost_pass("norm_kernel", B * D, 4 * D)
    elif mr:
        _cost_pass("split_kernel", B * D)
    _cost_mv(k, fmt, B, H, D, dual=True)
    if mr:
        _cost_pass("split_kernel", B * H)
    _cost_mv(k, fmt, B, D, H, resid=resid2)
    if qkv:
        _cost_pass("norm_kernel", B * D, 4 * D)
        _cost_mv(k, fmt, B, qkv, D)


# ---------------------------------------------------------------------------
# K2: qmm_decode
# ---------------------------------------------------------------------------


def decode_path(B: int) -> str:
    """Which kernel loop a decode product of B rows takes on the card, in
    either mode: "one-row" (``qmv_kernel``, ``gf4_mv_kernel``: f32
    operands and sums) at B = 1; 2-16 rows "multi-row" (``mmv_kernel``
    on the tensor cores, x staged as f16 hi + lo, each weight read once for
    every row); 17-64 rows "wide" (``wide_kernel``: x staged with one
    scale a row in one f16 term, each weight read once for every row; under
    --precise, hi + lo, ``mmw_kernel``). The quality mode takes the same
    launches at 2-16 rows: from the float64 product they read about half an
    f32 matmul's distance, about twice the f32 loops' (``csrc/qmm.cu``, the
    quality mode's note)."""
    _check(1 <= B <= MAX_MV_ROWS, f"the decode kernels take 1..{MAX_MV_ROWS} rows, not {B}")
    return "one-row" if B == 1 else "multi-row" if B <= MAX_ROWS else "wide"


def qmm_decode_plain(x: torch.Tensor, w: torch.Tensor, fmt: str,
                     layer=None, scale=None) -> torch.Tensor:
    wf = dequant(QTensor(_plane(w, layer), fmt), torch.float32)
    return _scaled(x.float() @ wf.T, scale, layer)


@cost.ranged
def qmm_decode(x: torch.Tensor, w: torch.Tensor, fmt: str,
               layer=None, scale=None) -> torch.Tensor:
    """x (B, n) f32 @ W[layer]^T for W (L, d, n) (or (d, n)) in storage
    dtype, (L, d, n/8) int32 words for gf4 -> (B, d) f32; fp8e4 times its
    scale (L, 1) (or (1,)), read by the kernel on the device; B <= 64. The
    path by :func:`decode_path`."""
    if fmt == "gf4":
        return qmm_decode_gf4(x, w, layer)
    if x.device.type == "cpu":
        return qmm_decode_plain(x, w, fmt, layer, scale)
    wl = _plane(w, layer)
    _check_cuda(fmt, x, [wl])
    _check(fmt in _FMT_CODE, f"qmm_decode takes fp16/fp8/fp8e4 weights, not {fmt!r}")
    sp = _scale_ptr(fmt, scale, w, layer, x)
    B, n = x.shape
    d = wl.shape[0]
    _check(wl.shape[1] == n, f"x has {n} columns, W has {wl.shape[1]}")
    path = decode_path(B)
    y = torch.empty((B, d), dtype=torch.float32, device=x.device)
    xs = sc = plan = None
    nterms = x_terms()
    if path != "one-row":
        plans, words, floats = _launch_plans(B, (((d,), n, False),), False, nterms)
        buf, xs, sc = _staging(words, floats, x.device)  # buf: held past the launch
        plan = plans.ctypes.data
    rc = build.lib("qmm").calm_qmm_decode(
        x.data_ptr(), wl.data_ptr(), y.data_ptr(), B, d, n, _FMT_CODE[fmt], sp, xs, sc, plan,
        nterms, _stream(x))
    build.check("qmm", rc)
    if cost.active():
        _cost_path(path, fmt, B, d, n, "qmv_kernel")
    qmm_decode.launches += 1
    qmm_decode.multirow_launches += path == "multi-row"
    qmm_decode.wide_launches += path == "wide"
    return y


qmm_decode.launches = 0
qmm_decode.multirow_launches = 0
qmm_decode.wide_launches = 0


# ---------------------------------------------------------------------------
# K3 and K4: gf4 matvec and matmul
# ---------------------------------------------------------------------------


def _check_gf4(x: torch.Tensor, wl: torch.Tensor) -> tuple[int, int, int]:
    _check(x.dtype == torch.float32 and x.is_contiguous() and x.ndim == 2,
           "activations must be contiguous 2-D float32")
    _check(x.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    _check(wl.device == x.device, "weights and activations on different devices")
    _check(wl.dtype == torch.int32 and wl.is_contiguous(),
           "gf4 weights must be contiguous int32 words")
    R, n = x.shape
    d, n8 = wl.shape
    _check(n == 8 * n8, f"x has {n} columns, W has {n8} words (x8) per row")
    return R, d, n8


def qmm_decode_gf4_plain(x: torch.Tensor, w: torch.Tensor,
                         layer=None) -> torch.Tensor:
    return qmm_decode_plain(x, w, "gf4", layer)


@cost.ranged
def qmm_decode_gf4(x: torch.Tensor, w: torch.Tensor, layer=None) -> torch.Tensor:
    """x (B <= 64, n) f32 @ W[layer]^T for gf4 words W (L, d, n/8) (or
    (d, n/8)) -> (B, d) f32. One row takes ``csrc/gf4.cu``'s matvec; from 2
    rows x is staged and the multi-row kernels of ``csrc/qmm.cu`` (fmt 2;
    past 16 rows the wide path) read each word once for every row
    (:func:`decode_path`)."""
    if x.device.type == "cpu":
        return qmm_decode_gf4_plain(x, w, layer)
    wl = _plane(w, layer)
    B, d, n8 = _check_gf4(x, wl)
    path = decode_path(B)
    y = torch.empty((B, d), dtype=torch.float32, device=x.device)
    if path != "one-row":
        nterms = x_terms()
        plans, words, floats = _launch_plans(B, (((d,), 8 * n8, False),), True, nterms)
        buf, xs, sc = _staging(words, floats, x.device)  # buf: held past the launch
        rc = build.lib("qmm").calm_qmm_decode(
            x.data_ptr(), wl.data_ptr(), y.data_ptr(), B, d, 8 * n8, _OFFN_CODE["gf4"], None,
            xs, sc, plans.ctypes.data, nterms, _stream(x))
        build.check("qmm", rc)
    else:
        rc = build.lib("gf4").calm_gf4_matvec(x.data_ptr(), wl.data_ptr(), y.data_ptr(), B,
                                              d, n8, _stream(x))
        build.check("gf4", rc)
    if cost.active():
        _cost_path(path, "gf4", B, d, 8 * n8, "gf4_mv_kernel")
    qmm_decode_gf4.launches += 1
    qmm_decode_gf4.multirow_launches += path == "multi-row"
    qmm_decode_gf4.wide_launches += path == "wide"
    return y


qmm_decode_gf4.launches = 0
qmm_decode_gf4.multirow_launches = 0
qmm_decode_gf4.wide_launches = 0


def mm_supported(rows: int, wdata: torch.Tensor, fmt: str) -> bool:
    """qmm_prefill's eligibility, as pallas_qmm.mm_supported: gf4 words and
    prefill-sized row counts (<= 16 rows keep the matvec; 17..31 take the
    dequantized matmul)."""
    return fmt == "gf4" and wdata.ndim in (2, 3) and rows >= MIN_MM_ROWS


qmm_prefill_plain = qmm_decode_gf4_plain  # the same function, any row count
qmm_prefill_w2_plain = qmm_decode_gf4_plain


def prefill_operand(x: torch.Tensor, rows_ok: bool = True) -> torch.Tensor:
    """x as the gf4 matmul kernel reads it on the card: bf16, rounded once,
    as JAX casts x before its ``pallas_call`` (``pallas_qmm.py:303``,
    ``:384``). A caller that feeds one activation to several products
    (wq/wk/wv, w1/w3) rounds it once here; on the CPU, or when ``rows_ok``
    is false (the product will not take the kernel), x stays f32."""
    if x.is_cuda and rows_ok and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def _gf4_matmul(x: torch.Tensor, w: torch.Tensor, layer) -> torch.Tensor:
    wl = _plane(w, layer)
    xb = prefill_operand(x).contiguous()
    _check(xb.dtype == torch.bfloat16 and xb.ndim == 2,
           "activations must be 2-D float32 or bfloat16")
    _check(xb.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    _check(wl.device == x.device, "weights and activations on different devices")
    _check(wl.dtype == torch.int32 and wl.is_contiguous(),
           "gf4 weights must be contiguous int32 words")
    R, n = xb.shape
    d, n8 = wl.shape
    _check(n == 8 * n8, f"x has {n} columns, W has {n8} words (x8) per row")
    _check(R >= MIN_MM_ROWS, f"the matmul kernel takes >= {MIN_MM_ROWS} rows")
    y = torch.empty((R, d), dtype=torch.float32, device=x.device)
    rc = build.lib("gf4").calm_gf4_matmul(xb.data_ptr(), wl.data_ptr(),
                                          y.data_ptr(), R, d, n8, _stream(x))
    build.check("gf4", rc)
    if cost.active():  # x in bf16, the words once, y in f32
        cost.record("gf4_mm_kernel", 2 * R * n + d * n // 2 + 4 * R * d, 2 * R * d * n)
    return y


@cost.ranged
def qmm_prefill(x: torch.Tensor, w: torch.Tensor, layer=None) -> torch.Tensor:
    """x (R >= 32, n) f32 (or bf16, from :func:`prefill_operand`) @
    W[layer]^T for gf4 words W (L, d, n/8) (or (d, n/8)) -> (R, d) f32. On
    the card the weights decode exactly to bf16 and x is rounded once to
    bf16, as the TPU kernel rounds it."""
    if x.device.type == "cpu":
        return qmm_prefill_plain(x, w, layer)
    y = _gf4_matmul(x, w, layer)
    qmm_prefill.launches += 1
    return y


qmm_prefill.launches = 0


@cost.ranged
def qmm_prefill_w2(h: torch.Tensor, w2: torch.Tensor, layer=None) -> torch.Tensor:
    """The FFN's down product at prefill: h (R >= 32, H) f32 or bf16 @
    w2[layer]^T for gf4 words w2 (L, D, H/8) -> (R, D) f32, as
    :func:`qmm_prefill`."""
    if h.device.type == "cpu":
        return qmm_prefill_w2_plain(h, w2, layer)
    y = _gf4_matmul(h, w2, layer)
    qmm_prefill_w2.launches += 1
    return y


qmm_prefill_w2.launches = 0


# ---------------------------------------------------------------------------
# fp16/fp8/fp8e4 products past 64 rows (XLA in JAX): qmm_mm8
# ---------------------------------------------------------------------------


class Mm8Plan(NamedTuple):
    """One launch of ``mm8_kernel``: blocks of MM8_ROWS weight rows against
    a token tile of ``width`` rows of x, the k of a tile split into ``ks``
    parts, the ``ks`` consecutive blocks of one cluster, which add their
    sums in rank order (part 0 first) through distributed shared memory,
    each for its share of the tile's tokens. Block b takes k part b % ks,
    token tile b // ks % ttiles and row tile b // (ks ttiles): a weight
    tile's token tiles run together, so the tile comes from L2 after the
    first."""
    width: int   # N, the compiled token tile (MM8_WIDTHS)
    ttiles: int  # token tiles: (ttiles - 1) width < R <= ttiles width
    rtiles: int  # row tiles of MM8_ROWS
    ks: int      # k parts (1, 2, 4 or 8)
    stages: int  # MM8_K-value stages of k
    R: int       # rows of x
    d: int       # output rows

    @property
    def grid(self) -> int:
        return self.rtiles * self.ttiles * self.ks

    @property
    def units(self) -> int:
        """Row x token tiles."""
        return self.rtiles * self.ttiles

    def args(self) -> tuple[int, int, int, int]:
        """What ``calm_mm8`` takes: {width, ttiles, ks, grid}."""
        return (self.width, self.ttiles, self.ks, self.grid)

    def block_work(self, block: int) -> tuple[int, int, int, int, int, int, int, int]:
        """(first row, end row, first token, end token, first stage, end
        stage, first token stored, end token stored) of block ``block`` as
        the kernel computes them, rows and tokens clipped to d and R: part
        kp stores the tile's tokens [kp width / ks, (kp + 1) width / ks)."""
        kp, tt, rt = (block % self.ks, block // self.ks % self.ttiles,
                      block // (self.ks * self.ttiles))
        t0 = tt * self.width
        return (rt * MM8_ROWS, min((rt + 1) * MM8_ROWS, self.d), t0,
                min(t0 + self.width, self.R), kp * self.stages // self.ks,
                (kp + 1) * self.stages // self.ks,
                min(t0 + kp * self.width // self.ks, self.R),
                min(t0 + (kp + 1) * self.width // self.ks, self.R))


def mm8_plan(R: int, d: int, n: int) -> Mm8Plan:
    """``mm8_kernel``'s tiling of x (R, n) against a (d, n) plane, k = n a
    positive multiple of 16, as an H100 timed it best (PERF.md §6). Token
    tiles: of the splits of R into tiles of at most 256 rows, the one that
    pads R the least, then the one with the fewest tiles (R <= 256: one
    tile, so an expert group reads each weight tile once; 1025: six of 192).
    The k split (a cluster's blocks): 8 parts where a launch has at most
    MM8_FEW_UNITS row x token tiles (k/v up to 512 rows, a router's 8 rows);
    2 where that fills the card's waves of blocks (one an SM) better by
    MM8_WAVE_GAIN or more (w2, q and o to 256 rows, at 1025); else none.
    Clusters of 4 timed slower than of 2 or 8 at every shape tried. Each
    part keeps MM8_MIN_STAGES stages where k allows."""
    _check(R >= 1 and d >= 1 and n >= 16 and n % 16 == 0,
           f"R, d >= 1 and k a positive multiple of 16, not {R}, {d}, {n}")
    return _mm8_plan(int(R), int(d), int(n))


@functools.lru_cache(maxsize=256)
def _mm8_plan(R: int, d: int, n: int) -> Mm8Plan:
    width, ttiles = None, None
    for t in range(-(-R // MM8_WIDTHS[-1]), -(-R // MM8_WIDTHS[0]) + 1):
        w = next(w for w in MM8_WIDTHS if w >= -(-R // t))
        if width is None or t * w < ttiles * width:
            width, ttiles = w, t
    rtiles, stages = -(-d // MM8_ROWS), -(-n // MM8_K)
    units = rtiles * ttiles

    def filled(blocks: int) -> float:  # the share of the waves' SM slots taken
        return blocks / (-(-blocks // SMS) * SMS)
    ks = 1
    if units <= MM8_FEW_UNITS:
        ks = MM8_MAX_KS
    elif filled(2 * units) >= filled(units) + MM8_WAVE_GAIN:
        ks = 2
    while ks > 1 and stages // ks < MM8_MIN_STAGES:
        ks //= 2
    return Mm8Plan(width, ttiles, rtiles, ks, stages, R, d)


def qmm_mm8_plain(x: torch.Tensor, w: torch.Tensor, fmt: str, layer=None,
                  scale=None) -> torch.Tensor:
    """The plain version: :func:`qmm_decode_plain`'s f32 product, any rows."""
    return qmm_decode_plain(x, w, fmt, layer, scale)


@cost.ranged
def qmm_mm8(x: torch.Tensor, w: torch.Tensor, fmt: str, layer=None,
            scale=None) -> torch.Tensor:
    """x (R, n) f32 (or bf16, from :func:`prefill_operand`) @ W[layer]^T
    for W (L, d, n) (or one plane (d, n)) in fp16/fp8/fp8e4 storage ->
    (R, d) f32; fp8e4 times its scale (L, 1) (or (1,)), read by the kernel
    on the device. On the card: x rounded once to bf16, the weights widened
    exactly to bf16 (fp16 rounded to nearest even), f32 sums, as JAX's XLA
    product (``calm_tpu/ops/qmm.py:189-205``), with no copy of the plane.
    On the CPU: ``dense_matmul``'s plain product (:func:`qmm_mm8_plain`'s
    function). ``model.mm_route`` sends it the products past 64 rows."""
    if x.device.type == "cpu":
        return dense_matmul(x, QTensor(w, fmt, scale), layer)
    _check(fmt in _FMT_CODE, f"qmm_mm8 takes fp16/fp8/fp8e4 weights, not {fmt!r}")
    wl = _plane(w, layer)
    xb = prefill_operand(x).contiguous()
    _check(xb.dtype == torch.bfloat16 and xb.ndim == 2,
           "activations must be 2-D float32 or bfloat16")
    _check(xb.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    _check(wl.device == x.device, "weights and activations on different devices")
    _check(wl.dtype == STORAGE[fmt] and wl.is_contiguous(),
           f"{fmt} weights must be contiguous {STORAGE[fmt]}")
    R, n = xb.shape
    d = wl.shape[0]
    _check(wl.shape[1] == n, f"x has {n} columns, W has {wl.shape[1]}")
    sp = _scale_ptr(fmt, scale, w, layer, x)
    plan = mm8_plan(R, d, n)
    y = torch.empty((R, d), dtype=torch.float32, device=x.device)
    rc = build.lib("mm").calm_mm8(xb.data_ptr(), wl.data_ptr(), y.data_ptr(), sp, R, d, n,
                                  _FMT_CODE[fmt], *plan.args(), _stream(x))
    build.check("mm", rc)
    if cost.active():  # x in bf16, the plane once, y in f32
        cost.record("mm8_kernel", 2 * R * n + d * n * _WBYTES[fmt] + 4 * R * d, 2 * R * d * n)
    qmm_mm8.launches += 1
    cost.count("qmm.mm8_rows", R)
    return y


qmm_mm8.launches = 0


# ---------------------------------------------------------------------------
# K9: qx_offn_qkv
# ---------------------------------------------------------------------------


def act(h: torch.Tensor, act_gelu: bool) -> torch.Tensor:
    """The FFN activation: tanh-GELU or SiLU (pallas_qmm.py:1010-1014)."""
    return F.gelu(h, approximate="tanh") if act_gelu else F.silu(h)


def _ffn_plain(x, w1, w3, w2, layer, fmt: str, act_gelu: bool):
    h = (act(qmm_decode_plain(x, w1, fmt, layer), act_gelu)
         * qmm_decode_plain(x, w3, fmt, layer))
    return qmm_decode_plain(h, w2, fmt, layer)


def _offn_plain(a, r, g, wo, w1, w3, w2, layer, fmt: str, act_gelu: bool,
                eps: float, sub_mean: bool):
    """(ffn, r1): r1 = r + a . wo^T, ffn = the FFN of ffn-norm(r1)."""
    r1 = r.float() + qmm_decode_plain(a, wo, fmt, layer)
    xn = rmsnorm(r1, g[layer], eps, sub_mean)
    return _ffn_plain(xn, w1, w3, w2, layer, fmt, act_gelu), r1


def qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                      fmt: str, act_gelu: bool, eps: float, sub_mean: bool):
    L = wo.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)
    ffn, r1 = _offn_plain(a, r, g, wo, w1, w3, w2, l, fmt, act_gelu, eps, sub_mean)
    x = r1 + ffn
    xq = rmsnorm(x, anx[ln], eps, sub_mean)
    return (x, *(qmm_decode_plain(xq, w, fmt, ln) for w in (wq, wk, wv)))


def _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt: str,
              act_gelu: bool, eps: float, sub_mean: bool):
    gs = 8 if fmt == "gf4" else 1  # values per stored element
    L, D = wo.shape[:2]
    Qd = wo.shape[2] * gs
    H = w1.shape[1]
    KVd = wk.shape[1]
    B = a.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)
    _check(0 <= l < L, f"layer {l} out of range for a stack of {L}")
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(tuple(a.shape) == (B, Qd) and tuple(r.shape) == (B, D),
           "attention output / residual shape mismatch")
    _check(tuple(w1.shape) == (L, H, D // gs) and tuple(w3.shape) == (L, H, D // gs)
           and tuple(w2.shape) == (L, D, H // gs)
           and tuple(wq.shape) == (L, Qd, D // gs)
           and tuple(wk.shape) == (L, KVd, D // gs)
           and tuple(wv.shape) == (L, KVd, D // gs), "weight stack shape mismatch")
    _check_cuda(fmt, a, [wo, w1, w3, w2, wq, wk, wv])
    for t in (r, g, anx):
        _check(t.dtype == torch.float32 and t.is_contiguous()
               and t.device == a.device and t.data_ptr() % 16 == 0,
               "residual and norm weights must be contiguous float32 on the card")
    _check(tuple(g.shape) == (L, D) and tuple(anx.shape) == (L, D),
           "norm weights must be (L, D)")
    _check(D <= MAX_NORM_DIM, f"the norm launch takes rows of <= {MAX_NORM_DIM}")
    dev = a.device
    multirow = B >= 2
    r1 = torch.empty((B, D), dtype=torch.float32, device=dev)
    xn = None if multirow else torch.empty((B, D), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    x = torch.empty((B, D), dtype=torch.float32, device=dev)
    qkv = torch.empty((B, Qd + 2 * KVd), dtype=torch.float32, device=dev)
    xs = sc = plans = None
    launches = (((D,), Qd, False), ((H,), D, True), ((D,), H, False), ((Qd, KVd, KVd), D, False))
    if multirow:  # wo, w1/w3, w2, q/k/v
        arr, words, floats = _launch_plans(B, launches, fmt == "gf4")
        buf, xs, sc = _staging(words, floats, dev)  # buf: held past the launch
        plans = arr.ctypes.data
    elif fmt == "gf4":
        arr = _row_plans(launches)  # held past the launch
        plans = arr.ctypes.data
    rc = build.lib("qmm").calm_qx_offn_qkv(
        a.data_ptr(), r.data_ptr(), _plane_ptr(g, l), _plane_ptr(anx, ln),
        _plane_ptr(wo, l), _plane_ptr(w1, l), _plane_ptr(w3, l),
        _plane_ptr(w2, l), _plane_ptr(wq, ln), _plane_ptr(wk, ln),
        _plane_ptr(wv, ln), r1.data_ptr(), None if xn is None else xn.data_ptr(),
        h.data_ptr(), x.data_ptr(), qkv.data_ptr(), B, D, H, Qd, KVd, _OFFN_CODE[fmt],
        int(act_gelu), float(eps), int(sub_mean), xs, sc, plans, _stream(a))
    build.check("qmm", rc)
    _cost_epilogue(fmt, B, D, H, Qd, Qd + 2 * KVd, resid2=True)
    return (x, qkv[:, :Qd], qkv[:, Qd:Qd + KVd], qkv[:, Qd + KVd:])


@cost.ranged
def qx_offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt: str,
                act_gelu: bool, eps: float, sub_mean: bool):
    """a (B, Qd) f32 attention output; r (B, D) f32 residual; g/anx (L, D)
    f32 ffn/attn norm weights; wo (L, D, Qd), w1/w3 (L, H, D), w2 (L, D, H),
    wq (L, Qd, D), wk/wv (L, KVd, D) in storage dtype ->
    (x_new (B, D), q (B, Qd), k (B, KVd), v (B, KVd)) with q/k/v projected
    from layer + 1, clamped to L - 1, without bias, clip or qk-norm.
    On CUDA, q, k and v are views of one (B, Qd + 2 KVd) buffer."""
    if a.device.type == "cpu":
        return qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv,
                                 layer, fmt, act_gelu, eps, sub_mean)
    _check(fmt in _EPILOGUE_FMTS, f"qx_offn_qkv takes fp8/fp16 weights, not {fmt!r}")
    out = _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt,
                    act_gelu, eps, sub_mean)
    qx_offn_qkv.launches += 1
    qx_offn_qkv.multirow_launches += a.shape[0] >= 2
    return out


qx_offn_qkv.launches = 0
qx_offn_qkv.multirow_launches = 0


def gf4_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                       act_gelu: bool, eps: float, sub_mean: bool):
    return qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                             "gf4", act_gelu, eps, sub_mean)


@cost.ranged
def gf4_offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                 act_gelu: bool, eps: float, sub_mean: bool):
    """:func:`qx_offn_qkv` on natural gf4 words: wo (L, D, Qd/8), w1/w3
    (L, H, D/8), w2 (L, D, H/8), wq (L, Qd, D/8), wk/wv (L, KVd, D/8)
    int32."""
    if a.device.type == "cpu":
        return gf4_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv,
                                  layer, act_gelu, eps, sub_mean)
    out = _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, "gf4",
                    act_gelu, eps, sub_mean)
    gf4_offn_qkv.launches += 1
    gf4_offn_qkv.multirow_launches += a.shape[0] >= 2
    return out


gf4_offn_qkv.launches = 0
gf4_offn_qkv.multirow_launches = 0


# ---------------------------------------------------------------------------
# K6 and K7: the gf4 FFN, and wo + residual + ffn-norm + FFN
# ---------------------------------------------------------------------------


def _check_ffn_words(w1, w3, w2, D: int, x: torch.Tensor) -> int:
    """Checks of one layer's natural gf4 FFN words against a model width D;
    returns the hidden width H."""
    H = w1.shape[0]
    for w in (w1, w3, w2):
        _check(w.device == x.device and w.dtype == torch.int32 and w.is_contiguous(),
               "gf4 weights must be contiguous int32 words on the activations' device")
    _check(tuple(w1.shape) == (H, D // 8) and tuple(w3.shape) == (H, D // 8)
           and tuple(w2.shape) == (D, H // 8) and H % 8 == 0,
           f"FFN words must be w1/w3 (H, D/8), w2 (D, H/8) for D={D}, got "
           f"{tuple(w1.shape)}, {tuple(w3.shape)}, {tuple(w2.shape)}")
    return H


def gf4_ffn_plain(x, w1, w3, w2, layer, act_gelu: bool):
    return _ffn_plain(x, w1, w3, w2, layer, "gf4", act_gelu)


@cost.ranged
def gf4_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
            layer, act_gelu: bool) -> torch.Tensor:
    """x (B <= 16, D) f32; w1/w3 (L, H, D/8), w2 (L, D, H/8) natural gf4
    words (or one layer's planes) -> (B, D) f32 = w2 . (act(w1 . x) * (w3
    . x)). Two launches of ``csrc/qmm.cu``, h between them in a buffer
    allocated here; from 2 rows four, on the multi-row path (x and h
    staged before the w1/w3 and w2 products)."""
    if x.device.type == "cpu":
        return gf4_ffn_plain(x, w1, w3, w2, layer, act_gelu)
    w1l, w3l, w2l = (_plane(w, layer) for w in (w1, w3, w2))
    B, _, _ = _check_gf4(x, w1l)
    D = x.shape[1]
    H = _check_ffn_words(w1l, w3l, w2l, D, x)
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    h = torch.empty((B, H), dtype=torch.float32, device=x.device)
    y = torch.empty((B, D), dtype=torch.float32, device=x.device)
    xs = sc = None
    launches = (((H,), D, True), ((D,), H, False))  # w1/w3, w2
    if B >= 2:
        arr, words, floats = _launch_plans(B, launches, True)
        buf, xs, sc = _staging(words, floats, x.device)  # buf: held past the launch
        plans = arr.ctypes.data
    else:
        arr = _row_plans(launches)  # held past the launch
        plans = arr.ctypes.data
    rc = build.lib("qmm").calm_gf4_ffn(
        x.data_ptr(), w1l.data_ptr(), w3l.data_ptr(), w2l.data_ptr(), h.data_ptr(),
        y.data_ptr(), B, D, H, int(act_gelu), xs, sc, plans, _stream(x))
    build.check("qmm", rc)
    _cost_epilogue("gf4", B, D, H)
    gf4_ffn.launches += 1
    gf4_ffn.multirow_launches += B >= 2
    return y


gf4_ffn.launches = 0
gf4_ffn.multirow_launches = 0


def gf4_ffn_supported(x_shape, w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """:func:`gf4_ffn`'s eligibility, as pallas_qmm.gf4_ffn_supported: a
    decode-sized batch and FFN words that match x."""
    return (1 <= x_shape[0] <= MAX_ROWS and x_shape[-1] == 8 * w1.shape[-1]
            and w1.shape[-2] == 8 * w2.shape[-1])


def gf4_offn_plain(a, r, g, wo, w1, w3, w2, layer, act_gelu: bool, eps: float,
                   sub_mean: bool):
    return _offn_plain(a, r, g, wo, w1, w3, w2, int(layer), "gf4", act_gelu, eps,
                       sub_mean)


@cost.ranged
def gf4_offn(a: torch.Tensor, r: torch.Tensor, g: torch.Tensor, wo: torch.Tensor,
             w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, layer,
             act_gelu: bool, eps: float, sub_mean: bool):
    """a (B <= 16, Qd) f32 attention output; r (B, D) f32 residual; g (L,
    D) f32 ffn-norm weights; wo (L, D, Qd/8), w1/w3 (L, H, D/8), w2 (L, D,
    H/8) natural gf4 words -> (ffn (B, D), r1 (B, D)) f32 with r1 = r + a
    . wo^T and ffn the FFN of ffn-norm(r1); the caller's new residual is
    r1 + ffn. Four launches of ``csrc/qmm.cu``; from 2 rows six, on the
    multi-row path (a, ffn-norm(r1) and h staged before their products)."""
    if a.device.type == "cpu":
        return gf4_offn_plain(a, r, g, wo, w1, w3, w2, layer, act_gelu, eps, sub_mean)
    wol, w1l, w3l, w2l = (_plane(w, layer) for w in (wo, w1, w3, w2))
    B, D, q8 = _check_gf4(a, wol)
    H = _check_ffn_words(w1l, w3l, w2l, D, a)
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(D % 4 == 0 and D <= MAX_NORM_DIM,
           f"the norm launch takes rows of a multiple of 4, <= {MAX_NORM_DIM}")
    for t in (r, g):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.device == a.device
               and t.data_ptr() % 16 == 0,
               "residual and norm weights must be contiguous float32 on the card")
    _check(tuple(r.shape) == (B, D) and g.ndim == 2 and g.shape[1] == D,
           f"r must be (B, D) and g (L, D) for D={D}")
    l = int(layer)
    _check(0 <= l < g.shape[0], f"layer {l} out of range for norm weights of {g.shape[0]}")
    dev = a.device
    multirow = B >= 2
    r1, ffn = (torch.empty((B, D), dtype=torch.float32, device=dev) for _ in range(2))
    xn = None if multirow else torch.empty((B, D), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    xs = sc = None
    launches = (((D,), 8 * q8, False), ((H,), D, True), ((D,), H, False))  # wo, w1/w3, w2
    if multirow:
        arr, words, floats = _launch_plans(B, launches, True)
        buf, xs, sc = _staging(words, floats, dev)  # buf: held past the launch
        plans = arr.ctypes.data
    else:
        arr = _row_plans(launches)  # held past the launch
        plans = arr.ctypes.data
    rc = build.lib("qmm").calm_gf4_offn(
        a.data_ptr(), r.data_ptr(), _plane_ptr(g, l), wol.data_ptr(), w1l.data_ptr(),
        w3l.data_ptr(), w2l.data_ptr(), r1.data_ptr(), None if xn is None else xn.data_ptr(),
        h.data_ptr(), ffn.data_ptr(), B, D, H, 8 * q8, int(act_gelu), float(eps),
        int(sub_mean), xs, sc, plans, _stream(a))
    build.check("qmm", rc)
    _cost_epilogue("gf4", B, D, H, 8 * q8)
    gf4_offn.launches += 1
    gf4_offn.multirow_launches += multirow
    return ffn, r1


gf4_offn.launches = 0
gf4_offn.multirow_launches = 0


# ---------------------------------------------------------------------------
# K10 and K11: expert-indexed matvecs for MoE decode
# ---------------------------------------------------------------------------


def qmm_moe_dense_plain(x: torch.Tensor, wstack: torch.Tensor, eidx: torch.Tensor,
                        cnt: torch.Tensor, fmt: str, layer=None, scale=None) -> torch.Tensor:
    A = eidx.shape[0]
    ids = eidx.to(wstack.device).long()
    planes = _plane(wstack, layer).index_select(0, ids)
    wf = dequant(QTensor(planes, fmt), torch.float32)  # (A, d, n)
    y = torch.einsum("abn,adn->abd", x.float().expand(A, -1, -1), wf)
    if scale is not None:  # each slot's expert's scale, (E, 1) of the layer
        y = y * _plane(scale, layer).index_select(0, ids)[:, None, :].to(y.device)
    live = torch.arange(A, device=y.device) < cnt.to(y.device).reshape(())
    return torch.where(live[:, None, None], y, 0.0)


def _check_slots(x: torch.Tensor, eidx: torch.Tensor, cnt: torch.Tensor) -> None:
    _check(eidx.dtype == torch.int32 and eidx.ndim == 1 and eidx.is_contiguous()
           and eidx.device == x.device, "eidx must be (A,) int32 on the card")
    _check(cnt.dtype == torch.int32 and cnt.numel() == 1 and cnt.device == x.device,
           "cnt must be one int32 on the card")


def _check_stack(x: torch.Tensor, w: torch.Tensor, fmt: str, layer) -> int:
    """Checks of one (L, E, d, n_packed) expert stack against x (.., n);
    returns its layer index."""
    _check(x.dtype == torch.float32 and x.is_contiguous() and x.data_ptr() % 16 == 0,
           "activations must be contiguous 16-byte aligned float32")
    _check(w.device == x.device and w.dtype == STORAGE[fmt] and w.is_contiguous()
           and w.ndim == 4, f"{fmt} expert stacks must be contiguous (L, E, d, n) "
           f"{STORAGE[fmt]} on the activations' device")
    gs = 8 if fmt == "gf4" else 1
    _check(x.shape[-1] == w.shape[-1] * gs and x.shape[-1] % 4 == 0,
           f"x has {x.shape[-1]} columns, W rows hold {w.shape[-1] * gs} "
           "(a multiple of 4)")
    _check(layer is not None and 0 <= int(layer) < w.shape[0],
           f"layer {layer} out of range for a stack of {w.shape[0]}")
    return int(layer)


def moe_multirow_supported(fmt: str, B: int, *ns: int) -> bool:
    """Whether the multi-row path takes the MoE sweep of B rows whose
    products contract ``ns``: 2..64 rows (past 16 the wide path) and whole
    16-value steps (fp16, fp8, fp8e4; gf4: whole words, a row may end
    half-way through a lane's 16 values). Other shapes take ``csrc/moe.cu``'s
    loops at up to 16 rows, as one row does (fp8e4 there at one row
    only)."""
    step = 8 if fmt == "gf4" else 16
    return (fmt in _OFFN_CODE and 2 <= B <= MAX_MV_ROWS
            and all(n >= step and n % step == 0 for n in ns))


@functools.lru_cache(maxsize=256)
def _live(cnt: torch.Tensor, A: int):
    """The live slots of a sweep, read once a trace ends: slots past
    ``cnt`` read no weights."""
    return lambda: min(int(cnt.reshape(-1)[0]), A)


def _moe_plans(B: int, A: int, launches: tuple, gf4: bool,
               terms: int = 1) -> tuple[np.ndarray, int, int]:
    """For the launches ``((rows, n, dual, staged), ...)`` of one call at B
    rows over A expert slots, each staging ``staged`` copies of its x (1
    shared, A one a slot; ``terms`` f16 terms on the wide path): their
    plans' kernel arguments in one int32 array, and the words and floats of
    the staging scratch they share."""
    ps = [qmv_plan(B, (rows,), n, dual, gf4, slots=A, terms=terms)
          for rows, n, dual, _ in launches]
    staged = [[k * v for v in p.staging(n, terms)] for p, (_, n, _, k) in zip(ps, launches)]
    return (np.array([v for p in ps for v in p.args()], dtype=np.int32),
            max(w for w, _ in staged), max(f for _, f in staged))


@cost.ranged
def qmm_moe_dense(x: torch.Tensor, wstack: torch.Tensor, eidx: torch.Tensor,
                  cnt: torch.Tensor, fmt: str, layer=None, scale=None) -> torch.Tensor:
    """The expert sweep: Y[a] = x[min(a, Ax - 1)] @ W[layer, eidx[a]]^T for
    x (Ax, B <= 64, n) f32 with Ax in {1, A}, W (L, E, d, n) fp16/fp8/fp8e4
    or (L, E, d, n/8) gf4 words, eidx (A,) int32 and cnt (1,) int32 on the
    device -> (A, B, d) f32; fp8e4 times scale[layer, eidx[a]] of its
    (L, E, 1) scale, which the kernel reads beside the id; slots a >= cnt
    give zeros. One row, or a shape :func:`moe_multirow_supported` declines
    (up to 16 rows), takes ``csrc/moe.cu`` (fp8e4 at one row only); 2-16
    rows the multi-row path, 17-64 the wide path (x staged once, or once a
    slot for Ax = A)."""
    if x.device.type == "cpu":
        return qmm_moe_dense_plain(x, wstack, eidx, cnt, fmt, layer, scale)
    _check(fmt in _OFFN_CODE, f"no CUDA kernel for weight format {fmt!r}")
    l = _check_stack(x, wstack, fmt, layer)
    _check_slots(x, eidx, cnt)
    sp = _scale_ptr(fmt, scale, wstack, l, x, experts=True)
    Ax, B, n = x.shape
    A = eidx.shape[0]
    _check(Ax in (1, A) and 1 <= B <= MAX_MV_ROWS,
           f"x must be (1 or {A}, 1..{MAX_MV_ROWS}, n), got {tuple(x.shape)}")
    d, E = wstack.shape[2], wstack.shape[1]
    y = torch.empty((A, B, d), dtype=torch.float32, device=x.device)
    multirow = moe_multirow_supported(fmt, B, n)
    _check(multirow or B == 1 or (fmt != "fp8e4" and B <= MAX_ROWS),
           f"fp8e4 expert rows of {n} values take one row, or 2..{MAX_MV_ROWS} of whole "
           f"16-value steps; other formats' rows off the steps at most {MAX_ROWS}")
    wide = multirow and B > MAX_ROWS
    if multirow:
        nterms = x_terms()
        plans, words, floats = _moe_plans(B, A, ((d, n, False, Ax),), fmt == "gf4", nterms)
        buf, xs, sc = _staging(words, floats, x.device)  # buf: held past the launch
        rc = build.lib("qmm").calm_moe_mmv(
            x.data_ptr(), _plane_ptr(wstack, l), y.data_ptr(), eidx.data_ptr(),
            cnt.data_ptr(), Ax, A, B, d, n, E, _OFFN_CODE[fmt], sp, xs, sc,
            plans.ctypes.data, nterms, _stream(x))
        build.check("qmm", rc)
    else:
        rc = build.lib("moe").calm_moe_dense(
            x.data_ptr(), _plane_ptr(wstack, l), y.data_ptr(), eidx.data_ptr(),
            cnt.data_ptr(), Ax, A, B, d, n, E, _OFFN_CODE[fmt], sp, _stream(x))
        build.check("moe", rc)
    if cost.active():
        live = _live(cnt, A)
        if wide:
            _cost_wide(fmt, B, d, n, slots=live, copies=Ax)
        else:
            if multirow:
                _cost_pass("split_kernel", Ax * B * n)
            _cost_mv("mmv_kernel" if multirow else "moe_gf4_kernel" if fmt == "gf4"
                     else "moe_qmv_kernel", fmt, B, d, n, slots=live)
    qmm_moe_dense.launches += 1
    qmm_moe_dense.multirow_launches += multirow and not wide
    qmm_moe_dense.wide_launches += wide
    return y


qmm_moe_dense.launches = 0
qmm_moe_dense.multirow_launches = 0
qmm_moe_dense.wide_launches = 0


def _check_moe_ffn(x, w1, w3, w2, eidx, cnt, fmt: str, layer) -> tuple[int, int, int, int, int]:
    """Checks of one call's expert FFN stacks w1/w3 (L, E, H, D), w2 (L, E,
    D, H) (gf4: the last dim in words) against x (B, D); returns (layer, B,
    D, H, E)."""
    l = _check_stack(x, w1, fmt, layer)
    _check_slots(x, eidx, cnt)
    _check(x.ndim == 2, f"x must be (B, D), got {tuple(x.shape)}")
    B, D = x.shape
    L, E, H, _ = w1.shape
    gs = 8 if fmt == "gf4" else 1
    _check(1 <= B <= MAX_MV_ROWS, f"the expert sweep takes 1..{MAX_MV_ROWS} rows")
    _check(w3.shape == w1.shape and w3.dtype == w1.dtype and w3.is_contiguous()
           and w3.device == x.device, "w3 must match w1")
    _check(tuple(w2.shape) == (L, E, D, H // gs) and H % gs == 0 and w2.dtype == w1.dtype
           and w2.is_contiguous() and w2.device == x.device,
           f"w2 must be (L, E, D, H/{gs}) = {(L, E, D, H // gs)}, got {tuple(w2.shape)}")
    return l, B, D, H, E


def _moe_ffn_mr(x, w1, w3, w2, eidx, cnt, fmt: str, act_gelu: bool, dims,
                scales=(None, None, None)) -> torch.Tensor:
    """The expert FFN on the multi-row path (``calm_moe_ffn``; past 16
    rows the wide path): x staged once, the dual w1/w3 launch of every slot
    into h (A, B, H), h staged a slot at a time, the w2 launch into z (A,
    B, D). dims: what
    :func:`_check_moe_ffn` returns; scales: the fp8e4 (L, E, 1) scales of
    w1, w3 and w2 (the dual launch scales each sum before the activation)."""
    l, B, D, H, E = dims
    A = eidx.shape[0]
    _check(moe_multirow_supported(fmt, B, D, H),
           f"the multi-row expert FFN takes 2..{MAX_MV_ROWS} rows of whole steps, not "
           f"B={B}, D={D}, H={H}")
    sp = [_scale_ptr(fmt, s, w, l, x, experts=True) for s, w in zip(scales, (w1, w3, w2))]
    h = torch.empty((A, B, H), dtype=torch.float32, device=x.device)
    z = torch.empty((A, B, D), dtype=torch.float32, device=x.device)
    nterms = x_terms()
    plans, words, floats = _moe_plans(B, A, ((H, D, True, 1), (D, H, False, A)), fmt == "gf4",
                                      nterms)
    buf, xs, sc = _staging(words, floats, x.device)  # buf: held past the launch
    rc = build.lib("qmm").calm_moe_ffn(
        x.data_ptr(), _plane_ptr(w1, l), _plane_ptr(w3, l), _plane_ptr(w2, l),
        eidx.data_ptr(), cnt.data_ptr(), h.data_ptr(), z.data_ptr(), A, B, D, H, E,
        _OFFN_CODE[fmt], int(act_gelu), *sp, xs, sc, plans.ctypes.data, nterms, _stream(x))
    build.check("qmm", rc)
    if cost.active():
        live = _live(cnt, A)
        if B > MAX_ROWS:
            _cost_wide(fmt, B, H, D, dual=True, slots=live)
            _cost_wide(fmt, B, D, H, slots=live, copies=A)
        else:
            _cost_pass("split_kernel", B * D)
            _cost_mv("mmv_kernel", fmt, B, H, D, dual=True, slots=live)
            _cost_pass("split_kernel", A * B * H)
            _cost_mv("mmv_kernel", fmt, B, D, H, slots=live)
    return z


def qmm_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, fmt: str, layer, act_gelu: bool,
                      scales=(None, None, None)):
    """Three plain sweeps and the activation, as ``_moe_sweep`` composed
    them (``calm_tpu/model.py:810-816``): each product scaled before the
    activation sees it."""
    x1 = x.float()[None]
    s1, s3, s2 = scales
    h = (act(qmm_moe_dense_plain(x1, w1, eidx, cnt, fmt, layer, s1), act_gelu)
         * qmm_moe_dense_plain(x1, w3, eidx, cnt, fmt, layer, s3))
    return qmm_moe_dense_plain(h, w2, eidx, cnt, fmt, layer, s2)


@cost.ranged
def qmm_moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                eidx: torch.Tensor, cnt: torch.Tensor, fmt: str, layer,
                act_gelu: bool, scales=(None, None, None)) -> torch.Tensor:
    """The whole fp16/fp8/fp8e4 expert FFN of each slot at 2-64 rows: x (B,
    D) f32, w1/w3 (L, E, H, D), w2 (L, E, D, H) in storage dtype -> z (A, B,
    D) f32 with z[a] = (act(s1 x W1[l,e]^T) * (s3 x W3[l,e]^T)) s2 W2[l,e]^T,
    e = eidx[a], the s the fp8e4 scales[l, e] of w1, w3 and w2 (``scales``,
    each (L, E, 1); None for other formats), read by the kernels on the
    device; slots a >= cnt give zeros. Four launches of ``csrc/qmm.cu`` (x
    staged, the dual w1/w3 product, h staged, w2), h and the staging in
    buffers allocated here. One row, and shapes that
    :func:`moe_multirow_supported` declines, take three
    :func:`qmm_moe_dense` calls instead (the caller's choice); on the card
    this wrapper raises for them. Counts one launch a call in
    ``.launches``, and in ``.multirow_launches`` (2-16 rows) or
    ``.wide_launches`` (17-64 rows, the wide path)."""
    if x.device.type == "cpu":
        return qmm_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, fmt, layer, act_gelu, scales)
    _check(fmt in _FMT_CODE, f"qmm_moe_ffn takes fp16/fp8/fp8e4 weights, not {fmt!r}")
    z = _moe_ffn_mr(x, w1, w3, w2, eidx, cnt, fmt, act_gelu,
                    _check_moe_ffn(x, w1, w3, w2, eidx, cnt, fmt, layer), scales)
    qmm_moe_ffn.launches += 1
    qmm_moe_ffn.multirow_launches += x.shape[0] <= MAX_ROWS
    qmm_moe_ffn.wide_launches += x.shape[0] > MAX_ROWS
    return z


qmm_moe_ffn.launches = 0
qmm_moe_ffn.multirow_launches = 0
qmm_moe_ffn.wide_launches = 0


def gf4_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, layer, act_gelu: bool):
    return qmm_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, "gf4", layer, act_gelu)


@cost.ranged
def gf4_moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, eidx: torch.Tensor, cnt: torch.Tensor, layer,
                act_gelu: bool) -> torch.Tensor:
    """The whole expert FFN of each slot on natural gf4 words: x (B <= 64,
    D) f32, w1/w3 (L, E, H, D/8), w2 (L, E, D, H/8) int32 -> z (A, B, D)
    f32 with z[a] = (act(x W1[l,e]^T) * (x W3[l,e]^T)) W2[l,e]^T, e =
    eidx[a]; slots a >= cnt give zeros. One row: two launches of
    ``csrc/moe.cu``, the h between them in a buffer allocated here; 2-64
    rows: :func:`qmm_moe_ffn`'s four launches of ``csrc/qmm.cu`` on gf4
    words (counted in ``.multirow_launches`` too, or past 16 rows in
    ``.wide_launches``)."""
    if x.device.type == "cpu":
        return gf4_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, layer, act_gelu)
    dims = l, B, D, H, E = _check_moe_ffn(x, w1, w3, w2, eidx, cnt, "gf4", layer)
    A = eidx.shape[0]
    multirow = B >= 2
    if multirow:
        z = _moe_ffn_mr(x, w1, w3, w2, eidx, cnt, "gf4", act_gelu, dims)
    else:
        h = torch.empty((A, B, H), dtype=torch.float32, device=x.device)
        z = torch.empty((A, B, D), dtype=torch.float32, device=x.device)
        rc = build.lib("moe").calm_gf4_moe_ffn(
            x.data_ptr(), _plane_ptr(w1, l), _plane_ptr(w3, l), _plane_ptr(w2, l),
            eidx.data_ptr(), cnt.data_ptr(), h.data_ptr(), z.data_ptr(), A, B, D, H, E,
            int(act_gelu), _stream(x))
        build.check("moe", rc)
        if cost.active():
            live = _live(cnt, A)
            _cost_mv("moe_gf4_kernel", "gf4", B, H, D, dual=True, slots=live)
            _cost_mv("moe_gf4_kernel", "gf4", B, D, H, slots=live)
    gf4_moe_ffn.launches += 1
    gf4_moe_ffn.multirow_launches += multirow and B <= MAX_ROWS
    gf4_moe_ffn.wide_launches += B > MAX_ROWS
    return z


gf4_moe_ffn.launches = 0
gf4_moe_ffn.multirow_launches = 0
gf4_moe_ffn.wide_launches = 0


def _offn_shapes_ok(B: int, shapes) -> bool:
    return (B <= MAX_ROWS and shapes[0] <= MAX_NORM_DIM
            and all(s % 128 == 0 for s in shapes))


def qx_offn_supported(fmt: str, B: int, shapes) -> bool:
    """The fused epilogue's eligibility, as pallas_qmm.qx_offn_supported:
    fp8/fp16 (fp8e4 decodes per op, as JAX's ``calm_tpu/model.py:1231``),
    decode-sized batch, 128-aligned (D, H, Qd, KVd), and D within the norm
    launch's row limit."""
    return fmt in _EPILOGUE_FMTS and _offn_shapes_ok(B, shapes)


def gf4_offn_supported(B: int, shapes) -> bool:
    """:func:`gf4_offn_qkv`'s and :func:`gf4_offn`'s eligibility on gf4
    weights: the same shapes as :func:`qx_offn_supported` (128-aligned
    dims are whole words)."""
    return _offn_shapes_ok(B, shapes)
