"""One-query cached attention (GQA) as a CUDA kernel.

Replaces the TPU kernel
``repro/kernels/prefill_attention.py::prefill_attention_pallas``: the
attention of one new token over a decode cache, which every decode step
and every scan-prefill position of the LM runs once per layer.  It
computes ``nn/attention.py::attend_full`` step by step: the scale is cast
to q's type first, ``q * scale`` is rounded in q's type, the scores sum in
float32, masked slots take -1e30, the softmax is ``exp(s - max) / sum`` in
float32, the probabilities are rounded to q's type before the PV product,
and PV sums in float32 before the output is rounded to q's type.  The
kernel (``csrc/prefill_attention.cu``) sums in another order than the
plain version, so the two agree to float32 rounding: within 1e-6 in
float32 and one bfloat16 ulp in bfloat16.

:func:`prefill_attention` sends CPU tensors to
:func:`prefill_attention_plain` and CUDA tensors to the kernel; anything
else raises.  ``prefill_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import prefill_attention_plain

_GRID_Y_MAX = 65535
_MAX_GROUP = 16                      # csrc: kMaxGroup
_MAX_GROUP_D = 16 * 256              # csrc: G * D outputs a block holds
_TILE_S = 64                         # csrc: kTileS
_SMEM_MAX = 232448                   # bytes of shared memory a block can use
_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["prefill_attention", "prefill_attention_plain", "library"]


def _check(q, k, v, mask):
    if q.dtype not in _DTYPES:
        raise TypeError(f"prefill_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        want = torch.int32 if name == "mask" else q.dtype
        if t.dtype != want:
            raise TypeError(f"prefill_attention: {name} must be {want}, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"prefill_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"prefill_attention: {name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"prefill_attention: q must be (B, H, D) and k "
                         f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b_dim, h_dim, d_dim = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b_dim, s_len, hkv, d_dim) or v.shape != k.shape:
        raise ValueError(f"prefill_attention: k and v must be "
                         f"{(b_dim, s_len, hkv, d_dim)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(mask.shape) != (b_dim, s_len):
        raise ValueError(f"prefill_attention: mask must be "
                         f"{(b_dim, s_len)}, got {tuple(mask.shape)}")
    if hkv == 0 or h_dim % hkv:
        raise ValueError(f"prefill_attention: {h_dim} query heads not "
                         f"grouped over {hkv} KV heads")
    return b_dim, h_dim, hkv, d_dim, s_len


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("prefill_attention")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.prefill_attention_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.prefill_attention_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def prefill_attention(q, k, v, mask):
    """One-query attention over a cache.  q: (B, H, D); k, v: (B, S, Hkv,
    D) of q's dtype; mask: (B, S) int32, nonzero where valid.  Returns
    (B, H, D) in q.dtype.

    CPU tensors take :func:`prefill_attention_plain`; CUDA tensors launch
    the kernel on the current stream, and a refused launch raises.
    """
    b_dim, h_dim, hkv, d_dim, s_len = _check(q, k, v, mask)
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: no kernel for {q.device}")
    group = h_dim // hkv
    if b_dim > _GRID_Y_MAX or group > _MAX_GROUP or s_len == 0 \
            or group * d_dim > _MAX_GROUP_D:
        raise ValueError(f"prefill_attention: needs B <= {_GRID_Y_MAX}, "
                         f"H/Hkv <= {_MAX_GROUP}, H/Hkv x D <= "
                         f"{_MAX_GROUP_D} and S >= 1; got B {b_dim}, "
                         f"H/Hkv {group}, D {d_dim}, S {s_len}")
    if 4 * (group * (d_dim + s_len) + _TILE_S * (d_dim + 1)) > _SMEM_MAX:
        raise ValueError(f"prefill_attention: a cache of {s_len} slots does "
                         f"not fit one block's shared memory")
    out = torch.empty_like(q)
    if b_dim == 0 or h_dim == 0 or d_dim == 0:
        return out
    # the reference casts the scale to q's dtype before it multiplies
    scale = torch.tensor(1.0 / math.sqrt(d_dim), dtype=q.dtype).item()
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.prefill_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b_dim, h_dim, hkv, d_dim, s_len, scale,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
