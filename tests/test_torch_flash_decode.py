"""The int8 KV cache: ``_quant_kv``, ``_dequant``, ``init_cache`` and the
int8 branch of ``decode_self_attention``, and the flash-decode kernel's
plain version and CPU wrapper (``repro_torch.kernels.flash_decode``),
against the JAX package's.

* ``_quant_kv``: codes and bfloat16 scales bitwise equal to the reference
  as it runs in the serving engine (under ``jax.jit``), including inputs
  whose ``amax`` divides by 127 to another float32 than it multiplies by
  the float32 reciprocal: XLA compiles the reference's ``amax / 127.0``
  into that multiplication, and the port computes the same.
* The plain flash decode against the dequantize-all oracle
  (``repro.kernels.ref.flash_decode_int8``) under ``jax.jit`` and the
  Pallas kernel (``ops.flash_decode_int8``, interpret mode), at the shapes
  of the JAX package's own flash-decode test: within 1e-6 (float32
  summation order and ``exp``; 6e-7 measured, against outputs of order 1),
  and the wrapper on the CPU is the plain version.
* ``decode_self_attention`` on an int8 cache, 6 steps: the cache bitwise
  (codes and scales) and the outputs within 1e-6 of the JAX ``ref`` path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.nn import attention as JA
from repro_torch.kernels import flash_decode as TFD
from repro_torch.nn import attention as TA

ATOL = 1e-6


def _reciprocal_cases(n):
    """Float32 values a with a / 127 != a * f32(1/127), as the amax."""
    a = np.random.default_rng(0).uniform(0, 10, 100_000).astype(np.float32)
    bad = a[a / np.float32(127) != a * (np.float32(1) / np.float32(127))]
    assert bad.size >= n
    return bad[:n]


def test_xla_compiles_division_by_127_as_reciprocal_multiplication():
    """Why the port multiplies: the jitted reference does, eager JAX does
    not, and the two disagree on these values."""
    a = jnp.asarray(_reciprocal_cases(64))
    jitted = np.asarray(jax.jit(lambda v: v / 127.0)(a))
    recip = np.asarray(a) * (np.float32(1) / np.float32(127))
    np.testing.assert_array_equal(jitted, recip)
    assert not np.array_equal(np.asarray(a / 127.0), recip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_bitwise(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (4, 1, 16, 8)).astype(np.float32)
    # half the rows get an amax whose /127 and *(1/127) differ
    bad = _reciprocal_cases(32).reshape(4, 1, 8)
    x[:, :, :8, :] = np.clip(x[:, :, :8, :], -1, 1)
    x[:, :, :8, 0] = bad
    x[:, :, :8, 1] = -0.5 * bad
    x[0, 0, 15] = 0.0                        # amax 0: the 1e-8 floor
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, js = jax.jit(JA._quant_kv)(jnp.asarray(x).astype(jdt))
    tq, ts = TA._quant_kv(torch.tensor(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    for q_dtype in (jnp.float32, jnp.bfloat16):
        want = np.asarray(JA._dequant(jq, js, q_dtype).astype(jnp.float32))
        got = TA._dequant(tq, ts, torch.float32 if q_dtype == jnp.float32
                          else torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_init_cache_quantized_layout():
    want = JA.init_cache(2, 5, 3, 4, quantized=True)
    got = TA.init_cache(2, 5, 3, 4, quantized=True, device="cpu")
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape
        assert str(got[name].dtype).replace("torch.", "") == str(leaf.dtype)
        assert not got[name].any()


@pytest.mark.parametrize("cfg", [(2, 8, 2, 32, 100), (1, 16, 1, 128, 513),
                                 (3, 4, 4, 64, 256)])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_and_pallas(cfg, scale_dtype):
    b, h, hkv, d, s_len = cfg
    rng = np.random.default_rng(s_len)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, s_len, hkv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, s_len, hkv, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (b, s_len, hkv)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (b, s_len, hkv)).astype(np.float32)
    ln = rng.integers(1, s_len, (b,)).astype(np.int32)
    sdt = jnp.bfloat16 if scale_dtype == "bfloat16" else jnp.float32
    jargs = [jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks).astype(sdt),
             jnp.asarray(v8), jnp.asarray(vs).astype(sdt), jnp.asarray(ln)]
    oracle = np.asarray(jax.jit(JREF.flash_decode_int8)(*jargs))
    pallas = np.asarray(JOPS.flash_decode_int8(*jargs))
    targs = [torch.tensor(np.asarray(a)) if a.dtype != jnp.bfloat16 else
             torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
             for a in jargs]
    got = TFD.flash_decode_int8_plain(*targs)
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    assert np.abs(got.numpy() - oracle).max() <= ATOL
    assert np.abs(got.numpy() - pallas).max() <= ATOL
    if scale_dtype == "bfloat16":        # the wrapper's operand types
        n0 = TFD.flash_decode_int8.launches
        assert torch.equal(TFD.flash_decode_int8(*targs), got)
        assert TFD.flash_decode_int8.launches == n0


def test_wrapper_checks_its_arguments():
    q = torch.zeros(2, 4, 8)
    k8 = torch.zeros(2, 5, 2, 8, dtype=torch.int8)
    sc = torch.zeros(2, 5, 2, dtype=torch.bfloat16)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="k8 must be torch.int8"):
        TFD.flash_decode_int8(q, k8.float(), sc, k8, sc, ln)
    with pytest.raises(TypeError, match="k_scale must be torch.bfloat16"):
        TFD.flash_decode_int8(q, k8, sc.float(), k8, sc, ln)
    with pytest.raises(ValueError, match="length must be"):
        TFD.flash_decode_int8(q, k8, sc, k8, sc, ln[:1])
    with pytest.raises(ValueError, match="grouped"):
        TFD.flash_decode_int8(q[:, :3].contiguous(), k8, sc, k8, sc, ln)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_self_attention_int8_matches_jax(dtype):
    b, d_model, h, hkv, hd, max_len, steps = 2, 32, 4, 2, 8, 8, 6
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = JA.attn_init(jax.random.PRNGKey(0), d_model, h, hkv, hd)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, rope_theta=1e4)
    jstep = jax.jit(lambda c, x, i: JA.decode_self_attention(
        p, x, c, i, analog_backend="ref", **kw))
    jc = JA.init_cache(b, max_len, hkv, hd, quantized=True)
    tc = TA.init_cache(b, max_len, hkv, hd, quantized=True, device="cpu")
    xs = np.random.default_rng(5).normal(0, 1, (steps, b, 1, d_model))
    for i in range(steps):
        x = xs[i].astype(np.float32)
        jy, jc = jstep(jc, jnp.asarray(x).astype(jdt), i)
        ty, tc = TA.decode_self_attention(
            tp, torch.tensor(x).to(tdt), tc, i, analog_backend="ref", **kw)
        assert ty.dtype == tdt
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                tc[name].float().numpy(),
                np.asarray(jc[name].astype(jnp.float32)))
        diff = np.abs(ty.float().numpy()
                      - np.asarray(jy.astype(jnp.float32))).max()
        # float32: summation order; bfloat16: one ulp of an output < 4
        assert diff <= (ATOL if dtype == "float32" else 2.0 ** -6), diff


def test_windowed_cache_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TA.decode_self_attention({}, torch.zeros(1, 1, 8), {}, 0, n_heads=1,
                                 n_kv_heads=1, head_dim=8, rope_theta=1e4,
                                 window=4)


def test_library_declares_pointer_arguments(monkeypatch):
    """Every pointer and the stream go through ctypes as ``c_void_p``, the
    scale as a float; an undeclared argument would be cut or mistyped."""
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        flash_decode_int8_launch=SimpleNamespace(argtypes=None,
                                                 restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TFD._build, "load", lambda name: fake)
    lib = TFD.library()
    assert lib.flash_decode_int8_launch.argtypes == \
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert lib.flash_decode_int8_launch.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p


@pytest.mark.parametrize("b,hkv,s_len", [
    (4, 16, 128), (4, 2, 128), (3, 8, 200), (1, 1, 32768), (4, 16, 2048),
    (1, 1, 31), (1, 1, 1), (128, 16, 4096), (2, 4, 16)])
def test_split_count_covers_the_card_within_its_limits(b, hkv, s_len):
    """The slots of a (KV head, batch row) go to ``split_count`` CTAs: 1 to
    8, each owning at least 32 slots unless S has fewer than 64, and no
    fewer than the H100's 132 SMs need, where S allows it.  Every CTA but
    the last owns ceil(S / splits) slots, so together they cover S, and
    none is left without a slot."""
    n = TFD.split_count(b, hkv, s_len)
    assert 1 <= n <= 8
    per = -(-s_len // n)
    assert per * n >= s_len and per * (n - 1) < s_len
    if n > 1:
        assert s_len // n >= 32
    if n < 8 and s_len // (n + 1) >= 32:
        assert b * hkv * n >= 132
    assert n == TFD.split_count(b, hkv, s_len)     # the shape alone


def test_serving_shape_splits_in_three():
    assert TFD.split_count(4, 16, 128) == 3        # 192 CTAs, 43 slots
    assert TFD.split_count(4, 2, 128) == 4         # G 8: 32 slots a CTA
    assert TFD.split_count(1, 16, 31) == 1


def test_kernel_shape_checks():
    """What the kernel takes beyond the plain version: D a multiple of 16
    up to 256 (a TMA box row of int8 codes), at most 8 query heads a KV
    head, B within the grid."""
    TFD._check_kernel_shape(4, 16, 16, 128)
    TFD._check_kernel_shape(4, 16, 2, 256)
    for args in ((4, 16, 16, 72), (4, 16, 16, 8), (4, 16, 16, 272),
                 (4, 16, 1, 128), (70000, 16, 16, 128)):
        with pytest.raises(ValueError, match="multiple of 16"):
            TFD._check_kernel_shape(*args)
