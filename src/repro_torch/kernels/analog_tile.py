"""One analog crossbar tile end to end as a CUDA kernel.

Replaces the TPU kernel ``repro/kernels/crossbar_mac.py::analog_tile_pallas``
and its wrapper ``repro/kernels/ops.py::analog_tile``:

    y = NLADC(pwm(f32(x)) @ (w + noise))   cast to x.dtype

PWM input quantization (``input_bits``; none without), pre-sampled read
noise on the weights (``w_noise``; none without), the float32 MAC, and the
strict comparator count against one ``(P,)`` ramp, decoded in closed form
(``fma(d, lsb, y0)``, one rounding, as ``jax.jit`` compiles the Pallas
body).  The kernel (``csrc/analog_tile.cu``) is bound by the bytes of w
and the noise at the PTB gate crossbar's shape: persistent CTAs (one per
SM, :func:`persistent_ctas`) walk a static list of (row block, column
strip) work items, CTA c taking items c, c + ctas, ... (item i is row block
i // strips, strip i % strips), while a producer warp streams w and the
noise through a ring of TMA loads.

Its summation order is not the plain version's, so the contract is the
fused matmul's (:func:`~repro_torch.kernels.fused_matmul_nladc.code_flips`)
with the bound computed on the effective operands ``pwm(x)`` and
``w + noise`` (:func:`effective_operands`); outputs equal the closed form
at the kernel's codes.

:func:`analog_tile` flattens x's leading dims and sends CPU tensors to
:func:`analog_tile_plain`, CUDA tensors to the kernel; anything else
raises.  A launch takes its config (rows of x and columns of w of a work
item, and K rows of a ring stage) from :mod:`repro_torch.kernels.tune` at
``(M, K, N)``; without a tune cache or override that is 16 rows, 32
columns and 128 K rows.  No config changes the summation order, so every
config computes the same bits.
``analog_tile.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.nladc import pwm_constants
from repro_torch.kernels import _build, tune
from repro_torch.kernels.ref import (ClosedForm, analog_tile_plain,
                                    effective_operands)

_DTYPES = (torch.float32, torch.bfloat16)
_SMS: dict = {}                         # device index -> its SM count

__all__ = ["analog_tile", "analog_tile_plain", "effective_operands",
           "library", "persistent_ctas"]


def persistent_ctas(m_dim: int, n_dim: int, rows: int, cols: int,
                    sms: int) -> int:
    """The CTAs a launch runs: one per SM, fewer where there are fewer
    work items (row blocks of ``rows`` rows times strips of ``cols``
    columns)."""
    return max(1, min(sms, -(-m_dim // rows) * -(-n_dim // cols)))


def _sm_count(device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _check(x, w, w_noise, thr):
    if x.dtype not in _DTYPES:
        raise TypeError(f"analog_tile: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    tensors = {"w": w, "thr": thr}
    if w_noise is not None:
        tensors["w_noise"] = w_noise
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"analog_tile: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"analog_tile: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"analog_tile: {name} must be contiguous")
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"analog_tile: x (..., K) and w (K, N) do not "
                         f"match: {tuple(x.shape)}, {tuple(w.shape)}")
    if w_noise is not None and w_noise.shape != w.shape:
        raise ValueError(f"analog_tile: w_noise {tuple(w_noise.shape)} is "
                         f"not w's {tuple(w.shape)}")
    if thr.dim() != 1:
        raise ValueError(f"analog_tile: thr must be (P,) (the kernel takes "
                         f"no banks), got {tuple(thr.shape)}")


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("analog_tile")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.analog_tile_launch.argtypes = [p] * 5 + [i] * 6 + [f] * 3 + \
        [i] * 2 + [f] * 3 + [i] * 4 + [p]
    lib.analog_tile_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def analog_tile(x, w, thr, dec: ClosedForm, *, w_noise=None,
                input_bits=None, input_clip: float = 1.0, blocks=None):
    """``NLADC(pwm(x) @ (w + w_noise))`` in x.dtype.  x: (..., K) float32
    or bfloat16; w, w_noise: (K, N) float32 (``w_noise`` None: no read
    noise); thr: (P,) float32; dec: the ramp's closed-form decode
    (:func:`~repro_torch.kernels.ref.closed_form_params`); ``input_bits``
    None: no PWM; ``blocks``: a launch config ``(rows, cols, k_tile)`` in
    place of the tune seam's.  Returns (..., N).

    CPU tensors take :func:`analog_tile_plain`; CUDA tensors launch the
    kernel on the current stream, and a refused launch raises.
    """
    _check(x, w, w_noise, thr)
    lead, k_dim, n_dim = x.shape[:-1], w.shape[0], w.shape[1]
    x2 = x.reshape(-1, k_dim)
    m_dim = x2.shape[0]
    if x.device.type == "cpu":
        return analog_tile_plain(x2, w, w_noise, thr, dec, input_bits,
                                 input_clip).reshape(lead + (n_dim,))
    if x.device.type != "cuda":
        raise ValueError(f"analog_tile: no kernel for {x.device}")
    rows, cols, k_tile = tune.launch_config(
        "analog_tile", (m_dim, k_dim, n_dim), x.dtype, x.device, blocks)
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (n_dim,))
    x2 = x2.contiguous()
    step, recip = pwm_constants(input_bits, input_clip) \
        if input_bits is not None else (1.0, 1.0)
    # ctypes takes Python floats; a float32 widens to double exactly
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.analog_tile_launch(
            x2.data_ptr(), w.data_ptr(),
            w_noise.data_ptr() if w_noise is not None else None,
            thr.data_ptr(), out.data_ptr(), m_dim, k_dim, n_dim,
            thr.shape[0], int(x.dtype == torch.bfloat16),
            int(input_bits is not None), float(input_clip), float(recip),
            float(step), dec.mode,
            dec.m, dec.y0, dec.lsb_l, dec.lsb_r, rows, cols, k_tile,
            persistent_ctas(m_dim, n_dim, rows, cols, _sm_count(x.device)),
            stream)
    if err != 0:
        raise RuntimeError(f"analog_tile kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    analog_tile.launches += 1
    return out.reshape(lead + (n_dim,))


analog_tile.launches = 0

