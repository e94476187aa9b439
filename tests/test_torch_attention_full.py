"""The full-sequence attention: repro_torch's ``attend_chunked`` and
``self_attention`` against the JAX package's, on the same inputs (numpy
seeds) and the same weights.

Cases: several KV chunks with a padded last one (S 40 over chunks of 16),
one chunk longer than S (the LM's 1024 at S 12), GQA (4 heads over 2 KV
heads), ``window`` 0 and 5, float32 and bfloat16.  Tolerances: 1e-6 in
float32; one bfloat16 ulp of the larger output in bfloat16 (the two sum
the float32 scores and the PV products in different orders, and one
rounding to bfloat16 follows).  ``causal_mask`` is compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import layers as JL
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

F32_ATOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= F32_ATOL, diff.max()
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (diff <= ulp).all(), float((diff / ulp).max())


@pytest.mark.parametrize("q_len,kv_len,offset,window",
                         [(5, 9, 0, 0), (5, 9, 4, 0), (7, 7, 0, 3),
                          (4, 12, 8, 5)])
def test_causal_mask_bitwise(q_len, kv_len, offset, window):
    want = np.asarray(JL.causal_mask(q_len, kv_len, q_offset=offset,
                                     window=window))
    got = TL.causal_mask(q_len, kv_len, q_offset=offset, window=window)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,chunk,window", [(40, 16, 0), (40, 16, 5),
                                            (12, 1024, 0)])
def test_attend_chunked_matches_jax(dtype, s, chunk, window):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s * 10 + window)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)

    def jmask(kv_start, kv_len):
        return JL.causal_mask(s, kv_len, q_offset=-kv_start, window=window)

    def tmask(kv_start, kv_len):
        return TL.causal_mask(s, kv_len, q_offset=-kv_start, window=window)

    want = jax.jit(lambda a, b, c: JA.attend_chunked(
        a, b, c, mask_fn=jmask, kv_chunk=chunk))(
            *(jnp.asarray(t, jdt) for t in (q, k, v)))
    got = TA.attend_chunked(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                            mask_fn=tmask, kv_chunk=chunk)
    assert got.dtype == tdt and got.shape == (2, s, 4, 16)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [0, 5])
def test_self_attention_matches_jax(dtype, window):
    """Projections (QKV bias), RoPE, the chunked softmax over 3 chunks of
    16 (S 40) and the output projection, with the same weights."""
    jdt, tdt = DTYPES[dtype]
    d, h, hkv, hd, s = 32, 4, 2, 8, 40
    jp = JA.attn_init(jax.random.PRNGKey(window), d, h, hkv, hd,
                      qkv_bias=True)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                              a.shape), jp)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(window).standard_normal(
        (2, s, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, rope_theta=10000.0,
              window=window, kv_chunk=16)
    want = jax.jit(lambda p, a: JA.self_attention(p, a, **kw))(
        jp, jnp.asarray(x, jdt))
    got = TA.self_attention(tp, torch.from_numpy(x).to(tdt), **kw)
    _close(got, want, dtype)
