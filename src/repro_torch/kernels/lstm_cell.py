"""The fused LSTM tail (paper Eq. 5 / Fig. S6) as a CUDA kernel.

Replaces the TPU kernel ``repro/kernels/lstm_cell.py::lstm_gates_pallas``:

    f, i, o = sigmoid-NLADC(g_f, g_i, g_o);  a = tanh-NLADC(g_a)
    c' = fma(f, c, i*a);   h' = o * tanh-NLADC(c')

Five NL-ADCs, one read of (gates, c) and one write of (h', c').  The kernel
(``csrc/lstm_cell.cu``) decodes by a lookup in each ramp's ``y_table``, as
the reference backend does, and rounds ``c'`` once, so it is bitwise equal
to :func:`lstm_gates_plain`.  It is bound by latency at the main path's
shape; the source says why and how a CTA reads each threshold byte once.

:func:`lstm_gates` sends CPU tensors to :func:`lstm_gates_plain` and CUDA
tensors to the kernel; anything else raises.  ``lstm_gates.launches``
counts kernel launches.  A launch takes its config (rows a thread takes and
threads a CTA may use) from :mod:`repro_torch.kernels.tune` at ``(B, H)``;
without a tune cache or override that is 1 row and 256 threads.
:func:`launch_geometry` says what a config launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import fma_f32, thermometer_count

_GRID_Y_MAX = 65535
_MIN_COLS = 16                      # a half-warp reads 64 bytes of a row


def launch_geometry(rows: int, threads: int, b_dim: int, h_dim: int):
    """``(cols, groups, grid)`` that config ``(rows, threads)`` launches at
    ``(B, H)``: a CTA is ``groups`` row groups by ``cols`` columns (a
    multiple of 16, so a half-warp reads 64 contiguous bytes of a gate row;
    no wider than H needs), each thread one column and ``rows`` batch rows,
    so a CTA covers ``groups x rows`` of them: all of B where ``threads``
    allows."""
    groups = max(1, min(-(-b_dim // rows), threads // _MIN_COLS))
    cols = max(_MIN_COLS, threads // groups // _MIN_COLS * _MIN_COLS)
    cols = min(cols, -(-h_dim // _MIN_COLS) * _MIN_COLS)
    return cols, groups, (-(-h_dim // cols), -(-b_dim // (groups * rows)))


def lstm_gates_plain(gates, c, sig_thr, sig_y, tanh_thr, tanh_y):
    """The kernel's arithmetic in plain torch (any device).

    gates: (B, 4H) [f|a|i|o]; c: (B, H); ``*_thr``: (P,) or per-column
    (H, P); ``*_y``: (P+1,) decode tables.  Returns (h', c').
    """
    h_dim = gates.shape[-1] // 4
    gf, ga, gi, go = torch.split(gates, h_dim, dim=-1)
    f = sig_y[thermometer_count(gf, sig_thr)]
    a = tanh_y[thermometer_count(ga, tanh_thr)]
    i = sig_y[thermometer_count(gi, sig_thr)]
    o = sig_y[thermometer_count(go, sig_thr)]
    c_new = fma_f32(f, c, i * a)
    return o * tanh_y[thermometer_count(c_new, tanh_thr)], c_new


def _check(gates, c, sig_thr, sig_y, tanh_thr, tanh_y):
    tensors = {"gates": gates, "c": c, "sig_thr": sig_thr, "sig_y": sig_y,
               "tanh_thr": tanh_thr, "tanh_y": tanh_y}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_gates: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != gates.device:
            raise ValueError(f"lstm_gates: {name} is on {t.device}, "
                             f"gates on {gates.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_gates: {name} must be contiguous")
    if gates.dim() != 2 or gates.shape[1] % 4:
        raise ValueError(f"lstm_gates: gates must be (B, 4H), "
                         f"got {tuple(gates.shape)}")
    b_dim, h_dim = gates.shape[0], gates.shape[1] // 4
    if tuple(c.shape) != (b_dim, h_dim):
        raise ValueError(f"lstm_gates: c must be {(b_dim, h_dim)}, "
                         f"got {tuple(c.shape)}")
    p = sig_thr.shape[-1]
    for name, thr in (("sig_thr", sig_thr), ("tanh_thr", tanh_thr)):
        if tuple(thr.shape) not in ((p,), (h_dim, p)):
            raise ValueError(f"lstm_gates: {name} must be ({p},) or "
                             f"({h_dim}, {p}), got {tuple(thr.shape)}")
    for name, y in (("sig_y", sig_y), ("tanh_y", tanh_y)):
        if tuple(y.shape) != (p + 1,):
            raise ValueError(f"lstm_gates: {name} must be ({p + 1},), "
                             f"got {tuple(y.shape)}")
    return b_dim, h_dim, p


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("lstm_cell")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.lstm_gates_launch.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.lstm_gates_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def lstm_gates(gates, c, sig_thr, sig_y, tanh_thr, tanh_y, *, block=None):
    """Fused LSTM tail: (h', c') from gates (B, 4H) and c (B, H);
    ``block``: a launch config ``(rows, threads)`` (rows a thread takes,
    threads a CTA may use) in place of the tune seam's.

    CPU tensors take :func:`lstm_gates_plain`; CUDA tensors launch the
    kernel on the current stream, and a refused launch raises.
    """
    b_dim, h_dim, p = _check(gates, c, sig_thr, sig_y, tanh_thr, tanh_y)
    if gates.device.type == "cpu":
        return lstm_gates_plain(gates, c, sig_thr, sig_y, tanh_thr, tanh_y)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_gates: no kernel for {gates.device}")
    rows, threads = tune.launch_config("lstm_gates", (b_dim, h_dim),
                                       gates.dtype, gates.device, block)
    cols, groups, (_, grid_y) = launch_geometry(rows, threads, b_dim, h_dim)
    if grid_y > _GRID_Y_MAX:
        raise ValueError(f"lstm_gates: batch {b_dim} exceeds the grid's "
                         f"{_GRID_Y_MAX * groups * rows} rows")
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    if b_dim == 0 or h_dim == 0:
        return h_out, c_out
    lib = library()
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        err = lib.lstm_gates_launch(
            gates.data_ptr(), c.data_ptr(), sig_thr.data_ptr(),
            sig_y.data_ptr(), tanh_thr.data_ptr(), tanh_y.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b_dim, h_dim, p,
            p if sig_thr.dim() == 2 else 0, p if tanh_thr.dim() == 2 else 0,
            rows, cols, groups, grid_y, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    lstm_gates.launches += 1
    return h_out, c_out


lstm_gates.launches = 0
