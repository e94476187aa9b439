"""Kernels 5 and 6 at any query group: the port's plain versions and CPU
wrappers against the JAX package's Pallas kernels (interpret mode) and
oracles at groups the CUDA kernels take in chunks, and the chunked plans.

The reference's kernels take any H that is a multiple of Hkv
(``repro/kernels/prefill_attention.py:56-61``, ``flash_decode.py:76-114``).
The CUDA kernels split a group of more than 16 (kernel 5) or 8 (kernel 6)
query heads into chunks, each its own cluster, so the plain versions, which
set their contract, must compute every group: granite-34b's 48 heads over
one KV head, qwen2.5-32b's 5, and a group of 20 (uneven chunks of kernel
6).  Shapes are small (S, D); tolerances as the kernels' own CPU tests:
kernel 5 within 1e-6 in float32 and one bfloat16 ulp, kernel 6 within
1e-6.  ``decode_self_attention`` at G 48 runs the cuda backend's code on
the CPU against the JAX ``pallas`` backend, for a bfloat16 and an int8
cache.  ``prefill_attention.explained_differences``, the contract the
chunked groups are held to on the card, tells float32 rounding from a
fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.nn import attention as JA
from repro_torch.core import backend as TBK
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import prefill_attention as TPA
from repro_torch.nn import attention as TA

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

F32_ATOL = 1e-6
FLASH_ATOL = 1e-6
GROUPS = [  # b, h, hkv, d, s
    (2, 48, 1, 16, 24),        # granite-34b's group
    (2, 40, 8, 16, 24),        # qwen2.5-32b's: G 5
    (3, 20, 1, 32, 9)]         # G 20

KERNELS_ON_CPU = "cuda-on-cpu"
TBK.register_backend(KERNELS_ON_CPU, TBK.CudaBackend("cpu"))


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,d,s", GROUPS)
def test_prefill_attention_plain_matches_pallas(b, h, hkv, d, s, dtype):
    rng = np.random.default_rng(h * 100 + s)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = np.asarray(JOPS.prefill_attention(
        qj[:, None], kj, vj, jnp.asarray(mask != 0)[:, None, :])[:, 0]
        .astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    qt, kt, vt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
                  for a in (qj, kj, vj))
    mt = torch.tensor(mask)
    plain = TPA.prefill_attention_plain(qt, kt, vt, mt)
    n0 = TPA.prefill_attention.launches
    assert torch.equal(TPA.prefill_attention(qt, kt, vt, mt), plain)
    assert TPA.prefill_attention.launches == n0
    got = plain.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= F32_ATOL
    else:
        assert np.all(np.abs(got - want)
                      <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


@pytest.mark.parametrize("b,h,hkv,d,s", GROUPS)
def test_flash_decode_plain_matches_pallas(b, h, hkv, d, s):
    rng = np.random.default_rng(h + s)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k8, v8 = (rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (b, s, hkv)).astype(np.float32)
              for _ in range(2))
    ln = rng.integers(1, s, (b,)).astype(np.int32)
    jargs = [jnp.asarray(q), jnp.asarray(k8),
             jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(v8),
             jnp.asarray(vs).astype(jnp.bfloat16), jnp.asarray(ln)]
    oracle = np.asarray(jax.jit(JREF.flash_decode_int8)(*jargs))
    pallas = np.asarray(JOPS.flash_decode_int8(*jargs))
    targs = [torch.tensor(np.asarray(a)) if a.dtype != jnp.bfloat16 else
             torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
             for a in jargs]
    got = TFD.flash_decode_int8_plain(*targs)
    assert got.shape == (b, h, d)
    for want in (oracle, pallas):
        assert np.abs(got.numpy() - want).max() <= FLASH_ATOL
    n0 = TFD.flash_decode_int8.launches
    assert torch.equal(TFD.flash_decode_int8(*targs), got)
    assert TFD.flash_decode_int8.launches == n0


@pytest.mark.parametrize("module,cap", [(TPA, 16), (TFD, 8)])
def test_chunks_cover_every_group_evenly(module, cap):
    """ceil(G / cap) chunks as even as can be: none above the cap, none
    empty, together G heads; G <= cap is one chunk (the unchunked plan)."""
    for g in range(1, 300):
        gc = module.chunk_heads(g)
        chunks = -(-g // gc)
        assert gc <= cap and chunks == -(-g // cap)
        assert (chunks - 1) * gc < g <= chunks * gc
        if g <= cap:
            assert gc == g
    assert TPA.chunk_heads(48) == 16 and TPA.chunk_heads(20) == 10
    assert TFD.chunk_heads(48) == 8 and TFD.chunk_heads(20) == 7
    assert TPA.chunk_heads(5) == TFD.chunk_heads(5) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [128, 2048])
def test_a_chunked_group_takes_its_chunks_plan(s, dtype):
    """The cluster and shared memory of G 48 over one KV head are those of
    its chunks of 16 heads; qwen2.5-32b's G 5 is one chunk."""
    assert TPA.cluster_size(48, 1, 128, s, dtype) \
        == TPA.cluster_size(16, 1, 128, s, dtype)
    assert TPA.cluster_size(40, 8, 128, s, dtype) \
        == TPA.cluster_size(5, 1, 128, s, dtype)
    elem = dtype.itemsize
    cs = TPA.cluster_size(48, 1, 128, s, dtype)
    assert TPA.smem_bytes(16, 128, s, cs, elem) <= TPA._SMEM_MAX


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_self_attention_at_group_48_matches_jax_pallas(quantized):
    """G 48 over one KV head (granite-34b's heads at a small head dim): the
    cuda backend's code on the CPU (the kernels' plain versions) against
    the JAX ``pallas`` backend's kernels in interpret mode, 5 steps of a
    bfloat16 or int8 cache: the cache bitwise, the outputs within one
    bfloat16 ulp of an output below 4 (the int8 path's float32 output
    cast to bfloat16)."""
    b, d_model, h, hkv, hd, steps = 2, 32, 48, 1, 8, 5
    p = JA.attn_init(jax.random.PRNGKey(2), d_model, h, hkv, hd)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, rope_theta=1e4)
    jstep = jax.jit(lambda c, x, i: JA.decode_self_attention(
        p, x, c, i, analog_backend="pallas", **kw))
    jc = JA.init_cache(b, steps, hkv, hd, dtype=jnp.bfloat16,
                       quantized=quantized)
    tc = TA.init_cache(b, steps, hkv, hd, dtype=torch.bfloat16,
                       quantized=quantized, device="cpu")
    xs = np.random.default_rng(8).normal(0, 1, (steps, b, 1, d_model))
    for i in range(steps):
        x = xs[i].astype(np.float32)
        jy, jc = jstep(jc, jnp.asarray(x).astype(jnp.bfloat16), i)
        ty, tc = TA.decode_self_attention(
            tp, torch.tensor(x).bfloat16(), tc, i,
            analog_backend=KERNELS_ON_CPU, **kw)
        for name in tc:
            np.testing.assert_array_equal(
                tc[name].float().numpy(),
                np.asarray(jc[name].astype(jnp.float32)), err_msg=name)
        diff = np.abs(ty.float().numpy()
                      - np.asarray(jy.astype(jnp.float32))).max()
        assert diff <= 2.0 ** -6, (i, diff)


def _steps(q, k, v, mask):
    """``attend_full``'s float32 probabilities of one-query inputs."""
    b, h, d = q.shape
    hkv = k.shape[2]
    qg = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).reshape(
        b, hkv, h // hkv, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    s = torch.where((mask != 0)[:, None, None, :], s, -1e30)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_explained_differences_tell_rounding_from_faults(dtype):
    """The contract the chunked groups are held to on the card: the plain
    version explains itself; float32 rounding that moves an output off
    the plain version's toward the float64 evaluation is explained; a
    bfloat16 probability within float32 rounding of a rounding midpoint
    that rounds the other way is explained; an output moved by a few ulps
    more is not."""
    b, h, hkv, d, s = 2, 48, 1, 32, 40
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.normal(0, 1, shape), dtype=torch.float32)
               .to(dtype) for shape in ((b, h, d), (b, s, hkv, d),
                                        (b, s, hkv, d)))
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[1, 17:] = 0
    plain = TPA.prefill_attention_plain(q, k, v, mask)
    same = TPA.explained_differences(q, k, v, mask, plain)
    assert (same["outputs"], same["beyond"], same["unexplained"]) == (
        b * h * d, 0, 0)
    if dtype == torch.float32:
        assert same["kernel_f64"] == same["plain_f64"] < 1e-6
        off = TPA.explained_differences(q, k, v, mask, plain + 3e-6)
        assert off["beyond"] == off["unexplained"] == b * h * d
        qs = (q * torch.tensor(d ** -0.5)).double().reshape(b, hkv, h, d)
        sc = torch.einsum("bhgd,bshd->bhgs", qs, k.double())
        p = torch.softmax(torch.where((mask != 0)[:, None, None, :], sc,
                                      -1e30), -1)
        exact = torch.einsum("bhgs,bshd->bhgd", p, v.double()).reshape(
            b, h, d).float()
        assert TPA.explained_differences(q, k, v, mask,
                                         exact)["unexplained"] == 0
        return
    # a probability near a midpoint rounded the other way
    p = _steps(q, k, v, mask)
    ulp = 2.0 ** (torch.floor(torch.log2(p.clamp_min(1e-38))) - 7)
    frac = p / ulp - torch.floor(p / ulp)
    t = int(torch.argmin((frac - 0.5).abs().flatten()))
    rounded = p.bfloat16().float()
    other = torch.where(rounded > p, rounded - ulp, rounded + ulp)
    flipped = rounded.flatten().clone()
    flipped[t] = other.flatten()[t]
    got = torch.einsum("bhgs,bshd->bhgd", flipped.reshape(p.shape),
                       v.float()).reshape(b, h, d).bfloat16()
    res = TPA.explained_differences(q, k, v, mask, got)
    assert res["beyond"] > 0 and res["unexplained"] == 0
    bumped = (plain.float() * (1 + 4 * 2.0 ** -8)).bfloat16()
    assert TPA.explained_differences(q, k, v, mask,
                                     bumped)["unexplained"] > 0
