"""One-query cached attention: the port's ``attend_full``, plain version
and CPU wrapper against the JAX package's ``nn.attention.attend_full`` and
its Pallas kernel (``repro.kernels.ops.prefill_attention``, interpret
mode), with GQA (G = 4 query heads per KV head) and ragged masks.

Both sides take the same steps (scale cast to q's dtype, ``q * scale`` in
q's dtype, float32 scores, -1e30 fill, float32 softmax, probabilities
rounded to q's dtype, float32 PV), but sum in other orders and use their
own ``exp``.  Tolerances: float32 max abs diff 1e-6; bfloat16 at most one
bfloat16 ulp per element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.nn import attention as JA
from repro_torch.core import backend as TBK
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import prefill_attention as TPA
from repro_torch.nn import attention as TA

F32_ATOL = 1e-6
B, S, H, HKV, D = 3, 12, 8, 2, 16


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.0, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1.0, (B, S, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1.0, (B, S, HKV, D)).astype(np.float32)
    # ragged: row i sees its first length[i] slots (at least one)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0] = S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, k, v))
    return q, k, v, mask


def _bf16_ulp(a):
    """One bfloat16 ulp at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        assert np.max(np.abs(got - want)) <= F32_ATOL
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp)


def _jax(q, k, v, mask, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    full = JA.attend_full(qj[:, None], kj, vj,
                          jnp.asarray(mask != 0)[:, None, :])[:, 0]
    kern = JOPS.prefill_attention(qj[:, None], kj, vj,
                                  jnp.asarray(mask != 0)[:, None, :])[:, 0]
    return (np.asarray(full.astype(jnp.float32)),
            np.asarray(kern.astype(jnp.float32)))


def _torch(q, k, v, mask, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return tuple(torch.tensor(a).to(tdt) for a in (q, k, v)) + \
        (torch.tensor(mask),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_and_wrapper_match_jax(dtype, seed):
    q, k, v, mask = _inputs(dtype, seed)
    j_full, j_kern = _jax(q, k, v, mask, dtype)
    qt, kt, vt, mt = _torch(q, k, v, mask, dtype)
    plain = TPA.prefill_attention_plain(qt, kt, vt, mt)
    wrap = TPA.prefill_attention(qt, kt, vt, mt)
    assert plain.dtype == qt.dtype and torch.equal(plain, wrap)
    ref = TBK.get_backend("ref").prefill_attention(
        qt[:, None], kt, vt, (mt != 0)[:, None, :])[:, 0]
    assert torch.equal(plain, ref)
    for want in (j_full, j_kern):
        _assert_close(plain.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_full_matches_jax_with_several_queries(dtype):
    """The port's ``attend_full`` itself, with Sq = 3 queries and a
    (B, Sq, Skv) causal mask."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (2, 3, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (2, 5, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1, (2, 5, HKV, D)).astype(np.float32)
    mask = np.broadcast_to(np.arange(5)[None, None, :]
                           <= np.arange(3)[None, :, None] + 2, (2, 3, 5))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JA.attend_full(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                          jnp.asarray(mask))
    got = TA.attend_full(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                         torch.tensor(mask.copy()))
    _assert_close(got.float().numpy(),
                  np.asarray(want.astype(jnp.float32)), dtype)


def test_bf16_scale_is_cast_first():
    """The scale 1/sqrt(128) is rounded to bfloat16 before it multiplies
    (0.08837890625), as the reference's ``jnp.asarray(scale, q.dtype)``."""
    q = torch.ones((1, 1, 1, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16)
    k[..., 0] = 1.0
    v = torch.ones((1, 1, 1, 128), dtype=torch.bfloat16)
    out = TA.attend_full(q, k, v, torch.ones((1, 1, 1), dtype=torch.bool))
    assert torch.equal(out, v)
    assert torch.tensor(1 / 128 ** 0.5, dtype=torch.bfloat16).item() == \
        0.08837890625


def test_wrapper_rejects_bad_operands():
    qt, kt, vt, mt = _torch(*_inputs("float32", 0), "float32")
    TPA.prefill_attention(qt, kt, vt, mt)
    bad = [(qt.double(), kt, vt, mt),
           (qt, kt.to(torch.bfloat16), vt, mt),
           (qt, kt, vt, mt.to(torch.int64)),
           (qt, kt[:, :5], vt, mt),
           (qt, kt, vt, mt[:, :5]),
           (qt[:, :7], kt, vt, mt),
           (qt.transpose(1, 2).contiguous().transpose(1, 2), kt, vt, mt)]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            TPA.prefill_attention(*args)
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda").prefill_attention(
            qt[:, None], kt, vt, mt[:, None, :] != 0)
    # an int8 cache attends through decode_attention_int8, not here: the
    # ref backend's is the dequantize-all plain version, the cuda
    # backend's refuses a CPU tensor
    k8 = torch.zeros(kt.shape, dtype=torch.int8)
    sc = torch.ones(kt.shape[:-1], dtype=torch.bfloat16)
    ln = torch.full((qt.shape[0],), kt.shape[1], dtype=torch.int32)
    assert torch.equal(
        TBK.get_backend("ref").decode_attention_int8(qt, k8, sc, k8, sc, ln),
        TFD.flash_decode_int8_plain(qt, k8, sc, k8, sc, ln))
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda").decode_attention_int8(qt, k8, sc, k8, sc, ln)


def test_library_declares_pointer_arguments(monkeypatch):
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        prefill_attention_launch=SimpleNamespace(argtypes=None,
                                                 restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TPA._build, "load", lambda name: fake)
    lib = TPA.library()
    fn = lib.prefill_attention_launch
    assert fn.argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


# -- what the cluster kernel takes ------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("h,hkv,d,s,dtype,want", [
    (16, 2, 128, 128, BF16, 8),      # the serving shape: 64 CTAs
    (16, 2, 128, 128, F32, 8),
    (16, 2, 128, 1, BF16, 1),        # one slot, one CTA
    (16, 2, 128, 2, BF16, 2),
    (16, 2, 128, 100, BF16, 8),      # S not a multiple of the split
    (8, 2, 16, 12, BF16, 2),         # D 16: 16-byte V slices
    (8, 2, 16, 24, F32, 4),
    (16, 2, 128, 2048, BF16, 8),
    (16, 2, 128, 2048, F32, 16),     # only 16 CTAs hold it
    (16, 16, 64, 2048, BF16, 8),     # G 1, D 64
    (16, 1, 256, 128, F32, 8)])      # G 16, D 256
def test_cluster_size_fits_the_card(h, hkv, d, s, dtype, want):
    cs = TPA.cluster_size(h, hkv, d, s, dtype)
    assert cs == want
    elem = torch.empty((), dtype=dtype).element_size()
    assert (d // cs * elem) % 16 == 0
    assert TPA.smem_bytes(h // hkv, d, s, cs, elem) <= TPA._SMEM_MAX


def test_smem_bytes_at_the_serving_shape():
    """G 8, D 128, S 128, bfloat16, 8 CTAs: queries 4,128 B + scores 512 B
    + 16 K rows of 272 B + 128 V slices of 32 B, each region 128-aligned."""
    assert TPA.smem_bytes(8, 128, 128, 8, 2) == 13312


@pytest.mark.parametrize("h,hkv,d,s,dtype,match", [
    (16, 2, 4, 8, BF16, "multiple of 16"),
    (34, 2, 128, 8, BF16, "H/Hkv <= 16"),
    (16, 2, 128, 200_000, BF16, "does not fit"),
    (16, 2, 128, 0, BF16, "S >= 1")])
def test_cluster_size_refuses_what_the_kernel_cannot_take(h, hkv, d, s, dtype,
                                                          match):
    with pytest.raises(ValueError, match=match):
        TPA.cluster_size(h, hkv, d, s, dtype)


@pytest.mark.parametrize("group,d,s,elem,cluster", [
    (8, 128, 128, 2, 3),       # not a power of two
    (8, 128, 128, 2, 32),      # past the largest cluster
    (4, 16, 12, 2, 4),         # 8-byte V slices
    (8, 128, 2048, 4, 8)])     # 8 CTAs cannot hold the cache
def test_a_cluster_the_kernel_refuses_does_not_fit(group, d, s, elem,
                                                   cluster):
    """What the C launch refuses: :func:`cluster_size` passes over such a
    cluster and takes the next one down (or 16)."""
    assert not TPA._cluster_fits(group, d, s, cluster, elem)
