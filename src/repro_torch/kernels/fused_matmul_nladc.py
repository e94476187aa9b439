"""Matmul with a fused NL-ADC epilogue as CUDA kernels, dense and per
expert.

Replaces the TPU kernel
``repro/kernels/fused_matmul_nladc.py::fused_matmul_nladc_pallas``:

    out = y_table[#{j : f32(x) @ f32(w) + b > thr_j}]   cast to x.dtype

the LM's MLP gate projection with its silu NL-ADC in one pass over the
weight, and ``repro/kernels/ops.py::moe_fused_matmul``, the same vmapped
over the experts of a MoE layer (:func:`moe_fused_matmul`: one launch of
a kernel of its own, persistent CTAs that stream the experts' weights
through a TMA ring and read no weight of an expert whose capacity rows
are all zero; one threshold set for every expert).
Like the Pallas kernel it quantizes a float32 accumulator of the float32
product; it decodes by a lookup in the ramp's ``y_table``, as the
reference backend does.

The dense gate has two kernels (``csrc/fused_matmul_nladc.cu``), picked by
M alone (``tune.GEMV_MAX_ROWS``, 8; no launch config picks):

* M <= 8, serving's decode and prefill steps: a GEMV on the float32 CUDA
  cores, bound by the bytes of the weight, which it streams once;
* M > 8, training's M = B x S: a GEMM on the tensor cores.  The float32
  weight is split on the card at every call into three bfloat16 parts
  that sum to it exactly (:func:`~repro_torch.kernels.ref.split_bf16x3`),
  float32 x likewise (bfloat16 x is one part), so 3 (or 9) exact bfloat16
  products make each float32 multiply-add; every 32 K rows' products
  are summed on the tensor cores and added to a float32 sum with one
  rounding.  bfloat16 x whose rows are not a multiple of 16 bytes (or
  whose base is not 16-byte aligned), and float32 x, are first written as
  bfloat16 parts to a scratch tensor of the call.  It needs N a multiple
  of 4 and w 16-byte aligned, or it raises.

Both sum in another order than the plain version, so an accumulator within
float32 rounding of a threshold may land on the other side of it: the
contract is equal codes except where the float64 accumulator lies within
the float32 summation error bound ``(K+1) * 2**-24 * (sum|x*w| + |b|)`` of
a threshold between the two codes (:func:`accumulator_bound`,
:func:`code_flips`).  The GEMV sums with IEEE round-to-nearest, for which
the bound is proven; the tensor cores' accumulation inside 32 K rows
is not documented as such, so for the GEMM the bound holds by the card's
measurement.

:func:`fused_matmul_nladc` and :func:`moe_fused_matmul` send CPU tensors
to their plain versions (:func:`fused_matmul_nladc_plain`,
:func:`moe_fused_matmul_plain`) and CUDA tensors to the kernels; anything
else raises.  Each keeps its own count of calls that launched its kernel
in ``.launches``.  A launch takes its config from
:mod:`repro_torch.kernels.tune` at the call's ``(M, K, N)``, the expert
gate at its per-expert ``(C, K, N)`` as the JAX package's vmapped gate
does.  For the GEMV the config is (rows, columns, K tile) of a block, by
default 4 rows, 32 columns and a K tile of 512; for the GEMM (x rows,
output columns, ring stages at most) of a tile, by default 128, 128 and 4
(:func:`gemm_stages`); for the expert gate (rows, cols, K tile) of a work
item, by default 8 capacity rows, a 128-column strip and 64 K rows a ring
stage (:func:`expert_gate_stages`).  Every config of each computes the
same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import (fused_matmul_nladc_plain,
                                    moe_fused_matmul_plain)

_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_MAX = 232448           # bytes of shared memory a CTA can use
_GEMM_WG_COLS = 64           # csrc: kWgCols, output columns a warpgroup
_GEMM_BOX_BYTES = 64 * 128   # csrc: kBoxBytes, a w box of a ring stage
_GATE_WARPS = 16             # csrc: kGateWarps, the K split
_GATE_MAX_STAGES = 8         # csrc: kGateMaxStages
_GATE_PART_OUTPUTS = 256     # csrc: kPartOutputs

__all__ = ["accumulator_bound", "code_flips", "expert_gate_stages",
           "fused_matmul_nladc", "fused_matmul_nladc_plain", "gemm_stages",
           "library", "moe_fused_matmul", "moe_fused_matmul_plain"]


def accumulator_bound(x, w, bias=None):
    """The float64 accumulator ``x @ w + bias`` and, per element, the bound
    ``(K+1) * 2**-24 * (sum|x*w| + |bias|)`` on any float32 evaluation's
    error, whatever its summation order (one rounding per product and per
    add; the bias add is the (K+1)-th)."""
    x64, w64 = x.double(), w.double()
    acc, mag = x64 @ w64, x64.abs() @ w64.abs()
    if bias is not None:
        acc, mag = acc + bias.double(), mag + bias.double().abs()
    return acc, (x.shape[-1] + 1) * 2.0 ** -24 * mag


def code_flips(codes_a, codes_b, acc, bound, thr):
    """``(flips, unexplained)``: the elements whose two codes differ, and
    those of them where no threshold between the codes lies within
    ``bound`` of the float64 accumulator ``acc`` (which no float32
    rounding can explain).  thr: (P,) or per-column (N, P)."""
    p = thr.shape[-1]
    lo = torch.minimum(codes_a, codes_b)[..., None]
    hi = torch.maximum(codes_a, codes_b)[..., None]
    k = torch.arange(p, device=acc.device)
    between = (k >= lo) & (k < hi)
    near = (acc[..., None] - thr.double()).abs() <= bound[..., None]
    flips = codes_a != codes_b
    unexplained = flips & ~(between & near).any(-1)
    return int(flips.sum()), int(unexplained.sum())


def _check(x, w, bias, thr, y_table):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_matmul_nladc: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    tensors = {"x": x, "w": w, "thr": thr, "y_table": y_table}
    if bias is not None:
        tensors["bias"] = bias
    for name, t in tensors.items():
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"fused_matmul_nladc: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_matmul_nladc: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_matmul_nladc: {name} must be "
                             f"contiguous")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_matmul_nladc: x (M, K) and w (K, N) do not "
                         f"match: {tuple(x.shape)}, {tuple(w.shape)}")
    m_dim, k_dim = x.shape
    n_dim = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n_dim,):
        raise ValueError(f"fused_matmul_nladc: bias must be ({n_dim},), "
                         f"got {tuple(bias.shape)}")
    p = thr.shape[-1]
    if tuple(thr.shape) not in ((p,), (n_dim, p)):
        raise ValueError(f"fused_matmul_nladc: thr must be ({p},) or "
                         f"({n_dim}, {p}), got {tuple(thr.shape)}")
    if tuple(y_table.shape) != (p + 1,):
        raise ValueError(f"fused_matmul_nladc: y_table must be ({p + 1},), "
                         f"got {tuple(y_table.shape)}")
    return m_dim, k_dim, n_dim, p


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("fused_matmul_nladc")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.fused_matmul_nladc_launch.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_matmul_nladc_launch.restype = ctypes.c_int
    lib.fused_gemm_nladc_launch.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_gemm_nladc_launch.restype = ctypes.c_int
    lib.moe_fused_matmul_launch.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.moe_fused_matmul_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_matmul_nladc(x, w, bias, thr, y_table, *, blocks=None):
    """``NLADC(f32(x) @ w + bias)`` in x.dtype.  x: (M, K) float32 or
    bfloat16; w: (K, N) float32; bias: (N,) float32 or None; thr: (P,) or
    per-column (N, P) float32; y_table: (P+1,) float32; ``blocks``: a
    launch config in place of the tune seam's, ``(rows, cols, k_tile)``
    for M <= 8 (the GEMV), ``(rows, cols, stages)`` for M > 8 (the GEMM).

    CPU tensors take :func:`fused_matmul_nladc_plain`; CUDA tensors launch
    the kernel M picks on the current stream, and a refused launch raises.
    """
    m_dim, k_dim, n_dim, p = _check(x, w, bias, thr, y_table)
    if x.device.type == "cpu":
        return fused_matmul_nladc_plain(x, w, bias, thr, y_table)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_nladc: no kernel for {x.device}")
    blocks = tune.launch_config(
        "fused_matmul_nladc", (m_dim, k_dim, n_dim), x.dtype, x.device,
        blocks)
    gemm = m_dim > tune.GEMV_MAX_ROWS
    parts = 3 if x.dtype == torch.float32 else 1
    if gemm and (n_dim % 4 or w.data_ptr() % 16):
        raise ValueError(f"fused_matmul_nladc: the tensor-core path (M > "
                         f"{tune.GEMV_MAX_ROWS}) reads w by TMA: N must be a "
                         f"multiple of 4 and w 16-byte aligned; got N "
                         f"{n_dim}")
    if gemm and gemm_stages(blocks, p, thr.dim() == 2, parts) < 2:
        raise ValueError(f"fused_matmul_nladc: config {blocks} at P {p} "
                         f"leaves no room for two ring stages in a CTA's "
                         f"shared memory")
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=x.device)
    if m_dim == 0 or n_dim == 0:
        return out
    lib = library()
    args = (w.data_ptr(), bias.data_ptr() if bias is not None else None,
            thr.data_ptr(), y_table.data_ptr(), out.data_ptr(), m_dim, k_dim,
            n_dim, p, p if thr.dim() == 2 else 0,
            int(x.dtype == torch.bfloat16), *blocks)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if gemm:
            # bfloat16 x goes to TMA as it is where its rows and base are
            # 16-byte aligned; else the launch first writes its parts here
            staged = None
            if parts == 3 or (2 * k_dim) % 16 or x.data_ptr() % 16:
                k_pad = -(-max(k_dim, 1) // 8) * 8
                staged = torch.empty((parts, m_dim, k_pad),
                                     dtype=torch.bfloat16, device=x.device)
            err = lib.fused_gemm_nladc_launch(
                x.data_ptr(),
                staged.data_ptr() if staged is not None else None, *args,
                stream)
        else:
            err = lib.fused_matmul_nladc_launch(x.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul_nladc kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    fused_matmul_nladc.launches += 1
    return out


fused_matmul_nladc.launches = 0


def _align(v: int, to: int = 128) -> int:
    return (v + to - 1) // to * to


@functools.lru_cache(maxsize=256)
def gemm_stages(blocks, p: int, banked: bool, parts: int) -> int:
    """The ring stages the M > 8 GEMM runs with config ``blocks`` (rows,
    cols, stages at most) at P (``csrc: tc_plan``): what is left of a CTA's
    227 KB after the barriers, the table, the flat thresholds and (banked)
    one 64-column threshold strip per consumer warpgroup, in stages of
    cols / 32 float32 w boxes (64 K rows of 32 columns) and ``parts``
    bfloat16 x tiles of rows x 64.  The kernel needs at least 2."""
    rows, cols, cap = blocks
    wgs = cols // _GEMM_WG_COLS
    off_strip = _align(_align(128 + 4 * (p + 1), 16) + 4 * p, 16)
    strip = _GEMM_WG_COLS * p if banked else 0
    off_ring = _align(off_strip + 4 * wgs * strip, 1024)
    stage = wgs * 2 * _GEMM_BOX_BYTES + parts * rows * 128
    return min(max(_SMEM_MAX - off_ring - 1024, 0) // stage, cap)


@functools.lru_cache(maxsize=256)   # a serve step asks for one shape
def expert_gate_stages(blocks, e_dim: int, c_dim: int, k_dim: int, p: int,
                       elem: int, banked: bool) -> int:
    """The ring stages the expert gate runs with config ``blocks`` (rows,
    cols, k_tile) at E, C, K and P (``csrc: gate_plan``): what is left of a
    CTA's 227 KB after the thresholds, the column codes, the unit list, the
    partial sums, two x slots of ``rows`` x K elements and (banked) two
    threshold strips of ``cols`` x P, in stages of ``k_tile`` x ``cols``
    float32 weights, at most 8.  The kernel needs at least 2."""
    rows, cols, k_tile = blocks
    r2 = min(_GATE_PART_OUTPUTS // cols, rows)
    off_code = _align(256 + 4 * (2 * p + 1))
    off_units = _align(off_code + 4 * cols)
    off_part = _align(off_units + 4 * e_dim * -(-c_dim // rows))
    off_x = _align(off_part + 4 * _GATE_WARPS * r2 * cols)
    off_ring = off_x + 2 * _align(rows * k_dim * elem) \
        + (2 * _align(4 * cols * p) if banked else 0)
    room = max(_SMEM_MAX - off_ring, 0)
    return min(room // (4 * k_tile * cols), _GATE_MAX_STAGES)


_WORK: dict = {}


def _work_buffer(device: torch.device, stream: int,
                 n_units: int) -> torch.Tensor:
    """The expert gate's scratch for one stream of a device: three counters
    (the next work item, the CTAs done, the CTAs past the grid barrier),
    zero before each launch and zero again after it (the kernel's last CTA
    resets them), so launches in order on the stream share them; then one
    liveness flag per unit, written by every launch.  Allocated once per
    stream, and again when a launch needs more units."""
    key = (device.index, stream)
    buf = _WORK.get(key)
    if buf is None or buf.numel() < 3 + n_units:
        buf = _WORK[key] = torch.zeros(3 + n_units, dtype=torch.int32,
                                       device=device)
    return buf


def _check_moe(x, w, thr, y_table):
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_fused_matmul: x (E, C, d) and w (E, d, f) do "
                         f"not match: {tuple(x.shape)}, {tuple(w.shape)}")
    # the per-expert (C, d) @ (d, f) slabs obey the dense gate's operand
    # rules
    _check(x[0], w[0], None, thr, y_table)
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_fused_matmul: {name} must be contiguous")
    return x.shape[0], x.shape[1], x.shape[2], w.shape[2], thr.shape[-1]


def moe_fused_matmul(x, w, thr, y_table, *, blocks=None):
    """``NLADC(f32(x[e]) @ w[e])`` for every expert e, in x.dtype.  x:
    (E, C, d) float32 or bfloat16 dispatched expert buffers; w: (E, d, f)
    float32 expert weights; thr: (P,) or per-column (f, P) float32, shared
    by every expert; y_table: (P+1,) float32; ``blocks``: a launch config
    in place of the tune seam's (resolved at the per-expert ``(C, d, f)``).
    Returns (E, C, f).

    CPU tensors take :func:`moe_fused_matmul_plain`; CUDA tensors launch
    the expert-gate kernel once on the current stream (persistent CTAs
    taking (expert, rows, strip) items from a work counter of the stream's
    own), and a refused launch raises.
    """
    e_dim, c_dim, k_dim, n_dim, p = _check_moe(x, w, thr, y_table)
    if x.device.type == "cpu":
        return moe_fused_matmul_plain(x, w, thr, y_table)
    if x.device.type != "cuda":
        raise ValueError(f"moe_fused_matmul: no kernel for {x.device}")
    blocks = tune.launch_config(
        "fused_matmul_nladc", (c_dim, k_dim, n_dim), x.dtype, x.device,
        blocks, experts=e_dim)
    if n_dim % 4 or (k_dim * x.element_size()) % 16 \
            or any(t.data_ptr() % 16 for t in (x, w, thr)):
        raise ValueError(f"moe_fused_matmul: the weight stream needs N a "
                         f"multiple of 4, K x {x.element_size()} bytes a "
                         f"multiple of 16 and x, w, thr 16-byte aligned; got "
                         f"N {n_dim}, K {k_dim}")
    if expert_gate_stages(blocks, e_dim, c_dim, k_dim, p, x.element_size(),
                          thr.dim() == 2) < 2:
        raise ValueError(f"moe_fused_matmul: config {blocks} at K {k_dim}, "
                         f"P {p} leaves no room for two weight stages in a "
                         f"CTA's shared memory")
    rows, cols, k_tile = blocks
    out = torch.empty((e_dim, c_dim, n_dim), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        work = _work_buffer(x.device, stream, e_dim * -(-c_dim // rows))
        err = lib.moe_fused_matmul_launch(
            x.data_ptr(), w.data_ptr(), thr.data_ptr(), y_table.data_ptr(),
            out.data_ptr(), work.data_ptr(), e_dim, c_dim, k_dim, n_dim, p,
            p if thr.dim() == 2 else 0, int(x.dtype == torch.bfloat16),
            rows, cols, k_tile, stream)
    if err != 0:
        raise RuntimeError(f"moe_fused_matmul kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    moe_fused_matmul.launches += 1
    return out


moe_fused_matmul.launches = 0
