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
kernel (``csrc/prefill_attention.cu``) runs one thread-block cluster per
(KV head, batch row) and sums in another order than the plain version, so
the two agree to float32 rounding: within 1e-6 in float32 and one
bfloat16 ulp in bfloat16.  Its summation orders are fixed, so every
cluster size computes the same bits.

:func:`prefill_attention` sends CPU tensors to
:func:`prefill_attention_plain` and CUDA tensors to the kernel; anything
else raises.  ``prefill_attention.launches`` counts kernel launches.
:func:`cluster_size` and :func:`smem_bytes` say what the kernel takes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import prefill_attention_plain

_GRID_Y_MAX = 65535
_MAX_GROUP = 16                      # csrc: kMaxGroup
_CLUSTERS = (1, 2, 4, 8, 16)         # csrc: kMaxCluster; 16 is non-portable
_PORTABLE_CLUSTER = 8
_V_BOX = 256                         # csrc: kBoxMax, slots a V box holds
_RING = 2                            # csrc: kRing, V boxes of a long cache
_THREADS = 256                       # csrc: kThreads
_SMEM_MAX = 232448                   # bytes of shared memory a CTA can use
_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["cluster_size", "prefill_attention", "prefill_attention_plain",
           "library", "smem_bytes"]


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


def _align128(v: int) -> int:
    return (v + 127) // 128 * 128


def _full_bytes(group: int, d_dim: int, s_len: int, cluster: int,
                elem: int) -> tuple:
    """``(bytes before V, bytes with every V slot staged)`` of one CTA
    (``csrc: make_full_plan``)."""
    n_per = -(-s_len // cluster)
    off_own = _align128(128 + 4 * group * (d_dim + 1))
    off_r = _align128(off_own + 4 * group * n_per)
    r_bytes = max(n_per * (d_dim * elem + 16), 4 * group * (s_len + 1))
    box = min(s_len, _V_BOX)
    v_rows = -(-s_len // box) * box if box else 0
    off_v = _align128(off_r + r_bytes)
    return off_v, off_v + v_rows * (d_dim // cluster) * elem


def _slices_ok(d_dim: int, cluster: int, elem: int) -> bool:
    return d_dim % cluster == 0 and (d_dim // cluster * elem) % 16 == 0


def _long_cache(group: int, d_dim: int, s_len: int, elem: int) -> bool:
    """No cluster size stages every V slot (``csrc: make_plan``): the
    kernel streams V through a ring of boxes."""
    return not any(_slices_ok(d_dim, c, elem)
                   and _full_bytes(group, d_dim, s_len, c, elem)[1]
                   <= _SMEM_MAX for c in _CLUSTERS)


def smem_bytes(group: int, d_dim: int, s_len: int, cluster: int,
               elem: int) -> int:
    """Shared memory one CTA of the kernel uses (``csrc: make_plan``): the
    group's queries as float32 (rows of D + 1), this CTA's scores, its K
    rows (rows of D elements + 16 bytes; their space then holds the whole
    row's G x (S + 1) float32 scores), and its D / cluster columns of V
    for every slot, S rounded up to whole TMA boxes of up to 256 slots;
    for a long cache (:func:`_long_cache`), two such boxes."""
    off_v, full = _full_bytes(group, d_dim, s_len, cluster, elem)
    if not _long_cache(group, d_dim, s_len, elem):
        return full
    box = min(s_len, _V_BOX)
    return off_v + _RING * _align128(box * (d_dim // cluster) * elem)


def _cluster_fits(group, d_dim, s_len, cluster, elem) -> bool:
    if cluster not in _CLUSTERS or not _slices_ok(d_dim, cluster, elem):
        return False
    if _long_cache(group, d_dim, s_len, elem) \
            and group * (d_dim // cluster) > _THREADS:
        return False          # the ring's PV sum: one column a thread
    return smem_bytes(group, d_dim, s_len, cluster, elem) <= _SMEM_MAX


@functools.lru_cache(maxsize=256)   # a serve step asks for a few shapes
def cluster_size(h_dim: int, hkv: int, d_dim: int, s_len: int,
                 dtype) -> int:
    """The CTAs that share one (KV head, batch row): the largest power of
    two up to 8 (and up to S) whose CTAs fit, else 16 (a non-portable
    cluster, for caches eight CTAs cannot hold).  A long cache, which no
    cluster can stage whole, streams V through two boxes; a cluster then
    fits when its columns leave one (head, column) a thread.
    A cluster's CTA takes D / cluster columns of V, which must be a
    multiple of 16 bytes, and its shared memory (:func:`smem_bytes`) must
    fit the card's 227 KB.  Raises ValueError for what the kernel does not
    take."""
    elem = dtype.itemsize
    group = h_dim // hkv
    if group > _MAX_GROUP or s_len == 0 or (d_dim * elem) % 16:
        raise ValueError(f"prefill_attention: needs H/Hkv <= {_MAX_GROUP}, "
                         f"S >= 1 and D x {elem} bytes a multiple of 16; "
                         f"got H/Hkv {group}, S {s_len}, D {d_dim}")
    top = _PORTABLE_CLUSTER
    while top > 1 and top > s_len:
        top //= 2
    for c in [top >> i for i in range(top.bit_length())] + [16]:
        if _cluster_fits(group, d_dim, s_len, c, elem):
            return c
    raise ValueError(f"prefill_attention: a cache of {s_len} slots does not "
                     f"fit the shared memory of 16 CTAs (D {d_dim}, H/Hkv "
                     f"{group}, {dtype})")


@functools.lru_cache(maxsize=256)
def _scale(d_dim: int, dtype) -> float:
    """1/sqrt(D) cast to q's dtype, as the reference casts it before it
    multiplies (a host tensor; cached, so a call builds none)."""
    return torch.tensor(1.0 / math.sqrt(d_dim), dtype=dtype).item()


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("prefill_attention")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.prefill_attention_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.prefill_attention_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def prefill_attention(q, k, v, mask):
    """One-query attention over a cache.  q: (B, H, D); k, v: (B, S, Hkv,
    D) of q's dtype; mask: (B, S) int32, nonzero where valid.  Returns
    (B, H, D) in q.dtype.

    CPU tensors take :func:`prefill_attention_plain`; CUDA tensors launch
    the kernel on the current stream with :func:`cluster_size`'s cluster,
    and a refused launch raises.
    """
    b_dim, h_dim, hkv, d_dim, s_len = _check(q, k, v, mask)
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: no kernel for {q.device}")
    if b_dim > _GRID_Y_MAX:
        raise ValueError(f"prefill_attention: needs B <= {_GRID_Y_MAX}, "
                         f"got {b_dim}")
    out = _launch(q, k, v, mask,
                  cluster_size(h_dim, hkv, d_dim, s_len, q.dtype))
    prefill_attention.launches += 1
    return out


def _launch(q, k, v, mask, cluster: int):
    """The kernel on checked CUDA tensors with ``cluster`` CTAs a (KV
    head, batch row); the launch raises if the kernel refuses the cluster.
    Uncounted: only :func:`prefill_attention` counts its launches."""
    b_dim, h_dim, d_dim = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("prefill_attention: q, k and v must start on a "
                         "16-byte boundary (the bulk copies' alignment)")
    out = torch.empty_like(q)
    if b_dim == 0 or h_dim == 0 or d_dim == 0:
        return out
    scale = _scale(d_dim, q.dtype)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.prefill_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b_dim, h_dim, hkv, d_dim, s_len, cluster, scale,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    return out


prefill_attention.launches = 0
