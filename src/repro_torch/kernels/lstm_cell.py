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

The backward (Alg. 1's straight-through gradients of the tail) is
:func:`lstm_gates_bwd`: from the residuals ``(gates, c, thresholds)`` and
the cotangents of ``(h', c')`` it rematerializes the five codes as the
forward does and chains five STEs into ``(d_gates, d_c)``.  Its kernel
(``csrc/lstm_cell_bwd.cu``) launches at the forward's default geometry
(:data:`BWD_CONFIG`, no tune knob); CPU tensors take
:func:`lstm_gates_bwd_plain`, the same operations in the same order.
``lstm_gates_bwd.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import functions as F
from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import fma_f32, thermometer_count

_GRID_Y_MAX = 65535
_MIN_COLS = 16                      # a half-warp reads 64 bytes of a row
BWD_CONFIG = (1, 256)               # the backward's (rows, threads)


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


def lstm_gates_bwd_plain(gates, c, sig_thr, sig_y, tanh_thr, tanh_y, ct_h,
                         ct_c, *, sig_domain, tanh_domain, codes=None):
    """The backward kernel's arithmetic in plain torch (any device).

    Rematerializes f, a, i, o, ``c' = fma(f, c, i*a)`` and ``t`` as
    :func:`lstm_gates_plain` does, then ``ste(x, ct) = ct * g'(x)`` on the
    ramp's domain (``sig_domain`` / ``tanh_domain``: ``(lo, hi)``,
    inclusive): ``d_o = ste_sig(g_o, ct_h*t)``,
    ``d_c' = ct_c + ste_tanh(c', ct_h*o)``, ``d_f = ste_sig(g_f, d_c'*c)``,
    ``d_i = ste_sig(g_i, d_c'*a)``, ``d_a = ste_tanh(g_a, d_c'*i)``,
    each :func:`~repro_torch.core.functions.ste_tensor` (the NL-ADC's
    ``nladc_ste``): ``g'`` is ``s*(1 - s)`` with ``s = sigmoid(x)`` and
    ``1 - t*t`` with ``t = tanh(x)``.  Returns
    ``(d_gates (B, 4H) [f|a|i|o], d_c = d_c'*f)``; ``codes``, an int32
    ``(5, B, H)`` tensor, receives the five counts.
    """
    h_dim = gates.shape[-1] // 4
    gf, ga, gi, go = torch.split(gates, h_dim, dim=-1)
    n = [thermometer_count(gf, sig_thr), thermometer_count(ga, tanh_thr),
         thermometer_count(gi, sig_thr), thermometer_count(go, sig_thr)]
    f, a, i, o = sig_y[n[0]], tanh_y[n[1]], sig_y[n[2]], sig_y[n[3]]
    c_new = fma_f32(f, c, i * a)
    n.append(thermometer_count(c_new, tanh_thr))
    t = tanh_y[n[4]]
    if codes is not None:
        codes.copy_(torch.stack(n))

    def ste_sig(x, ct):
        return F.ste_tensor("sigmoid", x, ct, sig_domain)

    def ste_tanh(x, ct):
        return F.ste_tensor("tanh", x, ct, tanh_domain)

    d_o = ste_sig(go, ct_h * t)
    d_cn = ct_c + ste_tanh(c_new, ct_h * o)
    d_f = ste_sig(gf, d_cn * c)
    d_i = ste_sig(gi, d_cn * a)
    d_a = ste_tanh(ga, d_cn * i)
    return torch.cat([d_f, d_a, d_i, d_o], dim=-1), d_cn * f


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


def bwd_library() -> ctypes.CDLL:
    """The backward kernel's shared library, built on first use."""
    lib = _build.load("lstm_cell_bwd")
    lib.lstm_gates_bwd_launch.argtypes = [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 8 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    lib.lstm_gates_bwd_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def lstm_gates_bwd(gates, c, sig_thr, sig_y, tanh_thr, tanh_y, ct_h, ct_c,
                   *, sig_domain, tanh_domain, codes=None):
    """The tail's straight-through backward: ``(d_gates (B, 4H), d_c
    (B, H))`` from the forward's inputs and the cotangents ``ct_h``,
    ``ct_c`` of ``(h', c')``, all float32 (see
    :func:`lstm_gates_bwd_plain`).  ``codes``: an optional int32
    ``(5, B, H)`` tensor that receives the rematerialized counts.

    CPU tensors take :func:`lstm_gates_bwd_plain`; CUDA tensors launch the
    kernel on the current stream, and a refused launch raises.
    """
    b_dim, h_dim, p = _check(gates, c, sig_thr, sig_y, tanh_thr, tanh_y)
    for name, t in (("ct_h", ct_h), ("ct_c", ct_c)):
        if t.dtype != torch.float32 or t.device != gates.device \
                or not t.is_contiguous() or tuple(t.shape) != (b_dim, h_dim):
            raise ValueError(
                f"lstm_gates_bwd: {name} must be a contiguous float32 "
                f"({b_dim}, {h_dim}) tensor on {gates.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if codes is not None and (codes.dtype != torch.int32
                              or codes.device != gates.device
                              or not codes.is_contiguous()
                              or tuple(codes.shape) != (5, b_dim, h_dim)):
        raise ValueError(f"lstm_gates_bwd: codes must be a contiguous int32 "
                         f"(5, {b_dim}, {h_dim}) tensor on {gates.device}")
    if gates.device.type == "cpu":
        return lstm_gates_bwd_plain(
            gates, c, sig_thr, sig_y, tanh_thr, tanh_y, ct_h, ct_c,
            sig_domain=sig_domain, tanh_domain=tanh_domain, codes=codes)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_gates_bwd: no kernel for {gates.device}")
    cols, groups, (_, grid_y) = launch_geometry(*BWD_CONFIG, b_dim, h_dim)
    if grid_y > _GRID_Y_MAX:
        raise ValueError(f"lstm_gates_bwd: batch {b_dim} exceeds the grid's "
                         f"{_GRID_Y_MAX * groups} rows")
    d_gates = torch.empty_like(gates)
    d_c = torch.empty_like(c)
    if b_dim == 0 or h_dim == 0:
        return d_gates, d_c
    lib = bwd_library()
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        err = lib.lstm_gates_bwd_launch(
            gates.data_ptr(), c.data_ptr(), sig_thr.data_ptr(),
            sig_y.data_ptr(), tanh_thr.data_ptr(), tanh_y.data_ptr(),
            ct_h.data_ptr(), ct_c.data_ptr(), d_gates.data_ptr(),
            d_c.data_ptr(), None if codes is None else codes.data_ptr(),
            b_dim, h_dim, p, p if sig_thr.dim() == 2 else 0,
            p if tanh_thr.dim() == 2 else 0, cols, groups, grid_y,
            *sig_domain, *tanh_domain, stream)
    if err != 0:
        raise RuntimeError(f"lstm_gates_bwd kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    lstm_gates_bwd.launches += 1
    return d_gates, d_c


lstm_gates_bwd.launches = 0
