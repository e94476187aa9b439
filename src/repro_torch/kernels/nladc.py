"""The elementwise NL-ADC as a CUDA kernel.

Replaces the TPU kernel ``repro/kernels/nladc_kernel.py::nladc_pallas``:

    out = y_table[#{j : float(x) > thr_j}]   cast to x.dtype

for x of any shape, against one ``(P,)`` ramp or a per-column ``(N, P)``
threshold matrix over x's last axis (the threshold-bank layout).  On the
MoE serving path it quantizes the router's sigmoid scores.  The kernel
(``csrc/nladc.cu``) decodes by a lookup in the ramp's ``y_table``, as the
reference backend does, so it is bitwise equal to :func:`nladc_plain`; the
Pallas kernel decodes in closed form, which agrees on every code and
differs from the table by float rounding only.

:func:`nladc` sends CPU tensors to :func:`nladc_plain` and CUDA tensors to
the kernel; anything else raises.  ``nladc.launches`` counts kernel
launches.  A launch takes its config (rows in flight, one warp each, and
columns of a CTA) from :mod:`repro_torch.kernels.tune` at x's ``(M, N)``
rows and columns; without a tune cache or override that is 8 rows and 32
columns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import nladc_plain

_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["library", "nladc", "nladc_plain"]


def _check(x, thr, y_table):
    if x.dtype not in _DTYPES:
        raise TypeError(f"nladc: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("x", x), ("thr", thr), ("y_table", y_table)):
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"nladc: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"nladc: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"nladc: {name} must be contiguous")
    if x.dim() == 0:
        raise ValueError("nladc: x must have at least one axis")
    n_cols = x.shape[-1]
    p = thr.shape[-1]
    if tuple(thr.shape) not in ((p,), (n_cols, p)):
        raise ValueError(f"nladc: thr must be ({p},) or ({n_cols}, {p}), "
                         f"got {tuple(thr.shape)}")
    if tuple(y_table.shape) != (p + 1,):
        raise ValueError(f"nladc: y_table must be ({p + 1},), got "
                         f"{tuple(y_table.shape)}")
    return n_cols, p


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("nladc")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.nladc_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.nladc_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def nladc(x, thr, y_table, *, block=None):
    """``y_table[#{j : x > thr_j}]`` in x.dtype.  x: any shape, float32 or
    bfloat16; thr: (P,) or per-column (N, P) float32 over x's last axis;
    y_table: (P+1,) float32; ``block``: a launch config ``(rows, cols)`` in
    place of the tune seam's.

    CPU tensors take :func:`nladc_plain`; CUDA tensors launch the kernel on
    the current stream, and a refused launch raises.
    """
    n_cols, p = _check(x, thr, y_table)
    if x.device.type == "cpu":
        return nladc_plain(x, thr, y_table)
    if x.device.type != "cuda":
        raise ValueError(f"nladc: no kernel for {x.device}")
    m_rows = x.numel() // n_cols if n_cols else 0
    rows, cols = tune.launch_config("nladc", (m_rows, n_cols), x.dtype,
                                    x.device, block)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nladc_launch(
            x.data_ptr(), thr.data_ptr(), y_table.data_ptr(), out.data_ptr(),
            m_rows, n_cols, p, p if thr.dim() == 2 else 0,
            int(x.dtype == torch.bfloat16), rows, cols, stream)
    if err != 0:
        raise RuntimeError(f"nladc kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    nladc.launches += 1
    return out


nladc.launches = 0
