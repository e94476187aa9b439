"""Matmul with a fused NL-ADC epilogue as a CUDA kernel, dense and per
expert.

Replaces the TPU kernel
``repro/kernels/fused_matmul_nladc.py::fused_matmul_nladc_pallas``:

    out = y_table[#{j : f32(x) @ f32(w) + b > thr_j}]   cast to x.dtype

the LM's MLP gate projection with its silu NL-ADC in one pass over the
weight, and ``repro/kernels/ops.py::moe_fused_matmul``, the same vmapped
over the experts of a MoE layer (:func:`moe_fused_matmul`: one grouped
launch, the expert on the grid, one threshold set for every expert).
Like the Pallas kernel it promotes both operands to float32 and quantizes
the float32 accumulator; it decodes by a lookup in the ramp's
``y_table``, as the reference backend does.  The kernel
(``csrc/fused_matmul_nladc.cu``) is bound by the bytes of the weight at
the serving path's GEMV shapes; the source says how it streams them.

Its summation order is not the plain version's, so an accumulator within
float32 rounding of a threshold may land on the other side of it: the
contract is equal codes except where the float64 accumulator lies within
the float32 summation error bound ``(K+1) * 2**-24 * (sum|x*w| + |b|)`` of
a threshold between the two codes (:func:`accumulator_bound`,
:func:`code_flips`).

:func:`fused_matmul_nladc` and :func:`moe_fused_matmul` send CPU tensors
to their plain versions (:func:`fused_matmul_nladc_plain`,
:func:`moe_fused_matmul_plain`) and CUDA tensors to the kernel; anything
else raises.  Each keeps its own count of kernel launches in
``.launches``.  A launch takes its config (rows, columns and K tile of a
block) from :mod:`repro_torch.kernels.tune` at the call's ``(M, K, N)``,
the expert gate at its per-expert ``(C, K, N)`` as the JAX package's
vmapped gate does; without a tune cache or override that is 4 rows a
block for the dense gate and 8 for the expert gate, 32 columns and a K
tile of 512.  Every config computes the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import (fused_matmul_nladc_plain,
                                    moe_fused_matmul_plain)

_GRID_Y_MAX = 65535
_GRID_Z_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["accumulator_bound", "code_flips", "fused_matmul_nladc",
           "fused_matmul_nladc_plain", "library", "moe_fused_matmul",
           "moe_fused_matmul_plain"]


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
    lib.moe_fused_matmul_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.moe_fused_matmul_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_matmul_nladc(x, w, bias, thr, y_table, *, blocks=None):
    """``NLADC(f32(x) @ w + bias)`` in x.dtype.  x: (M, K) float32 or
    bfloat16; w: (K, N) float32; bias: (N,) float32 or None; thr: (P,) or
    per-column (N, P) float32; y_table: (P+1,) float32; ``blocks``: a
    launch config ``(rows, cols, k_tile)`` in place of the tune seam's.

    CPU tensors take :func:`fused_matmul_nladc_plain`; CUDA tensors launch
    the kernel on the current stream, and a refused launch raises.
    """
    m_dim, k_dim, n_dim, p = _check(x, w, bias, thr, y_table)
    if x.device.type == "cpu":
        return fused_matmul_nladc_plain(x, w, bias, thr, y_table)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_nladc: no kernel for {x.device}")
    rows, cols, k_tile = tune.launch_config(
        "fused_matmul_nladc", (m_dim, k_dim, n_dim), x.dtype, x.device,
        blocks)
    if -(-m_dim // rows) > _GRID_Y_MAX:
        raise ValueError(f"fused_matmul_nladc: {m_dim} rows exceed the "
                         f"grid's {_GRID_Y_MAX * rows}")
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=x.device)
    if m_dim == 0 or n_dim == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_matmul_nladc_launch(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            thr.data_ptr(), y_table.data_ptr(), out.data_ptr(),
            m_dim, k_dim, n_dim, p, p if thr.dim() == 2 else 0,
            int(x.dtype == torch.bfloat16), rows, cols, k_tile, stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul_nladc kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    fused_matmul_nladc.launches += 1
    return out


fused_matmul_nladc.launches = 0


def _check_moe(x, w, thr, y_table):
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_fused_matmul: x (E, C, d) and w (E, d, f) do "
                         f"not match: {tuple(x.shape)}, {tuple(w.shape)}")
    # the per-expert (C, d) @ (d, f) slabs obey the dense kernel's rules
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
    one grouped kernel (the expert on the grid) on the current stream, and
    a refused launch raises.
    """
    e_dim, c_dim, k_dim, n_dim, p = _check_moe(x, w, thr, y_table)
    if x.device.type == "cpu":
        return moe_fused_matmul_plain(x, w, thr, y_table)
    if x.device.type != "cuda":
        raise ValueError(f"moe_fused_matmul: no kernel for {x.device}")
    rows, cols, k_tile = tune.launch_config(
        "fused_matmul_nladc", (c_dim, k_dim, n_dim), x.dtype, x.device,
        blocks, default=tune.EXPERT_GATE_BLOCKS)
    if e_dim > _GRID_Z_MAX or -(-c_dim // rows) > _GRID_Y_MAX:
        raise ValueError(f"moe_fused_matmul: {e_dim} experts of capacity "
                         f"{c_dim} exceed the grid")
    out = torch.empty((e_dim, c_dim, n_dim), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_fused_matmul_launch(
            x.data_ptr(), w.data_ptr(), thr.data_ptr(), y_table.data_ptr(),
            out.data_ptr(), e_dim, c_dim, k_dim, n_dim, p,
            p if thr.dim() == 2 else 0, int(x.dtype == torch.bfloat16),
            rows, cols, k_tile, stream)
    if err != 0:
        raise RuntimeError(f"moe_fused_matmul kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    moe_fused_matmul.launches += 1
    return out


moe_fused_matmul.launches = 0
