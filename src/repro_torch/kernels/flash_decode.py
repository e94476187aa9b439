"""One-token flash decode over an int8 KV cache as a CUDA kernel.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode_int8``:
the attention of one new token over a cache stored as int8 codes with one
bfloat16 scale per (slot, KV head).  Every attention layer of an LM served
with ``kv_cache_dtype="int8"`` runs it once per decode step and per
scan-prefill position.  The int8 K/V tiles are dequantized inside the
kernel (``csrc/flash_decode_int8.cu``), never to device memory, and an
online softmax runs over tiles of slots with the ``length`` mask, as in the
Pallas kernel.  The kernel splits each (KV head, batch row)'s slots over a
thread-block cluster of :func:`split_count` CTAs, whose partial softmax
states one CTA combines in split order.  Any group H/Hkv is taken, as the
reference's kernel takes it: a group of more than 8 query heads is split
into :func:`chunk_heads`-sized chunks (granite-34b's 48: 6 of 8), each
its own cluster; a group of at most 8 is one chunk.  The query is multiplied by
``1/sqrt(D)`` rounded to float32, as the Pallas kernel does and as XLA
compiles the oracle's ``q / sqrt(d)`` (a division by a constant becomes a
multiplication by its float32 reciprocal in the jitted HLO).

The kernel sums in another order than the dequantize-all plain version
(:func:`flash_decode_int8_plain`, the reference's oracle op for op) and
rescales as it goes, so the two agree to float32 rounding: within 1e-5,
for every split count.  The split count is a function of the shape alone,
so a rerun of the same inputs gives the same bits.

:func:`flash_decode_int8` sends CPU tensors to the plain version and CUDA
tensors to the kernel; anything else raises.
``flash_decode_int8.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_int8_plain, inv_sqrt_d

_GRID_Y_MAX = 65535
_MAX_GROUP = 8                       # csrc: kMaxGroup, heads of a chunk
_MAX_D = 256                         # csrc: kMaxD
_MAX_SPLITS = 8                      # csrc: kMaxSplits (a portable cluster)
_MIN_SLOTS_PER_CTA = 32
_SMS = 132                           # H100 SXM: the split count's target
_Q_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["chunk_heads", "flash_decode_int8", "flash_decode_int8_plain",
           "library", "split_count"]


def chunk_heads(group: int) -> int:
    """The query heads a CTA takes (``csrc: chunk_heads``): a group of G
    heads split into ceil(G / 8) chunks as even as can be; G <= 8 is one
    chunk."""
    chunks = -(-group // _MAX_GROUP)
    return -(-group // chunks)


def split_count(b_dim: int, hkv: int, s_len: int) -> int:
    """CTAs per (KV head, batch row): the fewest that give the grid
    ``_SMS`` CTAs, but at least 32 slots a CTA and at most 8.  A function
    of the shape alone (never of the card or a tune cache): it sets the
    kernel's summation order."""
    want = -(-_SMS // max(1, b_dim * hkv))
    return max(1, min(want, _MAX_SPLITS, s_len // _MIN_SLOTS_PER_CTA))


def _check_kernel_shape(b_dim, d_dim):
    """What the kernel takes beyond the plain version's arguments (any
    group H/Hkv: :func:`chunk_heads`)."""
    if b_dim > _GRID_Y_MAX or d_dim > _MAX_D or d_dim % 16:
        raise ValueError(f"flash_decode_int8: needs B <= {_GRID_Y_MAX} and "
                         f"D <= {_MAX_D} a multiple of 16 (a TMA box row); "
                         f"got B {b_dim}, D {d_dim}")


def _check(q, k8, k_scale, v8, v_scale, length):
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"flash_decode_int8: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    want = {"k8": torch.int8, "v8": torch.int8, "k_scale": torch.bfloat16,
            "v_scale": torch.bfloat16, "length": torch.int32}
    tensors = {"q": q, "k8": k8, "k_scale": k_scale, "v8": v8,
               "v_scale": v_scale, "length": length}
    for name, t in tensors.items():
        if name in want and t.dtype != want[name]:
            raise TypeError(f"flash_decode_int8: {name} must be "
                            f"{want[name]}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_decode_int8: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode_int8: {name} must be "
                             f"contiguous")
    if q.dim() != 3 or k8.dim() != 4:
        raise ValueError(f"flash_decode_int8: q must be (B, H, D) and k8 "
                         f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k8.shape)}")
    b_dim, h_dim, d_dim = q.shape
    s_len, hkv = k8.shape[1], k8.shape[2]
    if tuple(k8.shape) != (b_dim, s_len, hkv, d_dim) or v8.shape != k8.shape:
        raise ValueError(f"flash_decode_int8: k8 and v8 must be "
                         f"{(b_dim, s_len, hkv, d_dim)}, got "
                         f"{tuple(k8.shape)}, {tuple(v8.shape)}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != (b_dim, s_len, hkv):
            raise ValueError(f"flash_decode_int8: {name} must be "
                             f"{(b_dim, s_len, hkv)}, got {tuple(t.shape)}")
    if tuple(length.shape) != (b_dim,):
        raise ValueError(f"flash_decode_int8: length must be ({b_dim},), "
                         f"got {tuple(length.shape)}")
    if hkv == 0 or h_dim % hkv:
        raise ValueError(f"flash_decode_int8: {h_dim} query heads not "
                         f"grouped over {hkv} KV heads")
    return b_dim, h_dim, hkv, d_dim, s_len


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("flash_decode_int8")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.flash_decode_int8_launch.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_decode_int8_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_decode_int8(q, k8, k_scale, v8, v_scale, length):
    """One-token attention over an int8 cache.  q: (B, H, D) float32 or
    bfloat16; k8, v8: (B, S, Hkv, D) int8; k_scale, v_scale: (B, S, Hkv)
    bfloat16; length: (B,) int32 valid-slot counts.  Returns (B, H, D)
    float32.

    CPU tensors take :func:`flash_decode_int8_plain`; CUDA tensors launch
    the kernel on the current stream, and a refused launch raises.
    """
    b_dim, h_dim, hkv, d_dim, s_len = _check(q, k8, k_scale, v8, v_scale,
                                             length)
    if q.device.type == "cpu":
        return flash_decode_int8_plain(q, k8, k_scale, v8, v_scale, length)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_int8: no kernel for {q.device}")
    return _launch(q, k8, k_scale, v8, v_scale, length,
                   split_count(b_dim, hkv, s_len),
                   (b_dim, h_dim, hkv, d_dim, s_len))


def _launch(q, k8, k_scale, v8, v_scale, length, splits, dims=None):
    """The kernel with ``splits`` CTAs per (KV head, batch row), 1 to 8
    (the card tests run every count); ``dims``: ``_check``'s result where
    the caller has it."""
    b_dim, h_dim, hkv, d_dim, s_len = dims or _check(q, k8, k_scale, v8,
                                                     v_scale, length)
    _check_kernel_shape(b_dim, d_dim)
    out = torch.empty((b_dim, h_dim, d_dim), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    scale = float(inv_sqrt_d(d_dim))          # exact as a float32 argument
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_int8_launch(
            q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
            v_scale.data_ptr(), length.data_ptr(), out.data_ptr(), b_dim,
            h_dim, hkv, d_dim, s_len, splits, scale,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_int8 kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    flash_decode_int8.launches += 1
    return out


flash_decode_int8.launches = 0
