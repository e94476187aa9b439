"""The fused matmul + NL-ADC: the port's plain version and CPU wrapper
against the JAX package's Pallas kernel (``repro.kernels.ops``, interpret
mode, as the JAX tests run it).

Both compute ``NLADC(f32(x) @ f32(w) + b)`` and cast to x's dtype, but sum
the float32 products in another order, so an accumulator within float32
rounding of a threshold may cross it on one side only.  The contract:

* codes equal, except where the float64 accumulator lies within the
  float32 summation error bound ``(K+1) * 2**-24 * (sum|x*w| + |b|)`` of a
  threshold between the two codes; such elements are counted and must be
  rare (at most 1%);
* where the codes agree, values agree within one float32 ulp,
  ``2**-23 * max(1, |y|)``, in float32: the port decodes by ``y_table``
  lookup, the Pallas kernel in closed form, and the two are up to one ulp
  apart (4.8e-7 at the silu ramp's top entry, 6.04; 6e-8 on the sigmoid
  ramp).  After the bfloat16 cast they are bitwise equal.

The JAX codes come from the same kernel run with a counting ramp (the
same thresholds, ``y(n) = n``): the silu ramp's table repeats a value, so
codes cannot be read back from decoded outputs.  M > 8 (a shape the card
sends to the tensor-core GEMM) is among the cases.

The GEMM's operands on the card are the exact three-way bfloat16 split of
float32 w (and of float32 x): its torch mirror, ``ref.split_bf16x3``, is
held to exactness in float64 here, and every product of parts to float32
exactness, so the card's sum differs from a float32 sum only in its order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nladc as JN
from repro.kernels import ops as JOPS
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.kernels.ref import split_bf16x3, thermometer_count

VALUE_RTOL = 2.0 ** -23
MAX_FLIP_SHARE = 0.01


def _count_ramp(ramp):
    p = len(ramp.thresholds)
    return dataclasses.replace(ramp, y_table=np.arange(p + 1.0),
                               split_index=-1, monotonic_split=False)


def _case(m, k, n, name, x_dtype, bias, tile_cols, seed):
    rng = np.random.default_rng(seed)
    ramp = JN.build_ramp(name, 5)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    if x_dtype == "bfloat16":      # values the bf16 operand can hold
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(0, 2.0 / np.sqrt(k), (k, n)).astype(np.float32)
    b = rng.normal(0, 0.5, (n,)).astype(np.float32) if bias else None
    thr64 = np.asarray(ramp.thresholds, np.float64)
    if tile_cols:
        bm_j = JN.bank_map_for(n, tile_cols)
        shift = rng.normal(0, 0.03, (bm_j.n_banks, 1))
        banks = (thr64[None, :] + shift).astype(np.float32)
        thr_j = JN.BankedThresholds(jnp.asarray(banks), bm_j)
        thr_t = TN.BankedThresholds(torch.from_numpy(banks),
                                    TN.bank_map_for(n, tile_cols)).per_column
    else:
        thr_j = jnp.asarray(thr64.astype(np.float32))
        thr_t = torch.from_numpy(thr64.astype(np.float32))
    return ramp, x, w, b, thr_j, thr_t


def _torch_args(x, w, b, thr_t, ramp, x_dtype):
    tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    return (torch.tensor(x).to(tdt), torch.tensor(w),
            torch.tensor(b) if b is not None else None, thr_t,
            torch.from_numpy(np.asarray(ramp.y_table, np.float32)))


CASES = [(m, k, n, name, dt, bias, tiles)
         for (m, k, n) in [(33, 40, 24), (4, 64, 160), (130, 96, 200)]
         for name in ("sigmoid", "silu")
         for dt in ("float32", "bfloat16")
         for bias, tiles in [(False, 0), (True, 0), (True, 16)]]


@pytest.mark.parametrize("m,k,n,name,x_dtype,bias,tile_cols", CASES)
def test_plain_and_wrapper_match_pallas(m, k, n, name, x_dtype, bias,
                                        tile_cols):
    ramp, x, w, b, thr_j, thr_t = _case(m, k, n, name, x_dtype, bias,
                                        tile_cols, seed=m * 100 + n)
    xj = jnp.asarray(x).astype(
        jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    bj = jnp.asarray(b) if b is not None else None
    n_j = torch.from_numpy(np.asarray(JOPS.fused_matmul_nladc(
        xj, jnp.asarray(w), _count_ramp(ramp), bj,
        thresholds=thr_j).astype(jnp.float32)).astype(np.int64))
    y_j = np.asarray(JOPS.fused_matmul_nladc(
        xj, jnp.asarray(w), ramp, bj, thresholds=thr_j).astype(jnp.float32))

    xt, wt, bt, thr, y_table = _torch_args(x, w, b, thr_t, ramp, x_dtype)
    y_plain = TFM.fused_matmul_nladc_plain(xt, wt, bt, thr, y_table)
    y_wrap = TFM.fused_matmul_nladc(xt, wt, bt, thr, y_table)
    assert y_plain.dtype == xt.dtype and torch.equal(y_plain, y_wrap)
    acc_t = xt.float() @ wt + (bt if bt is not None else 0.0)
    n_t = thermometer_count(acc_t, thr)
    assert torch.equal(y_plain, y_table[n_t].to(xt.dtype))

    acc, bound = TFM.accumulator_bound(xt, wt, bt)
    flips, unexplained = TFM.code_flips(n_t, n_j, acc, bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * n_t.numel()
    same = (n_t == n_j).numpy()
    y_t = y_plain.float().numpy()
    if x_dtype == "float32":
        tol = VALUE_RTOL * np.maximum(1.0, np.abs(y_j))
        assert np.all(np.abs(y_t - y_j)[same] <= tol[same])
    else:
        assert np.array_equal(y_t[same], y_j[same])


def test_flip_contract():
    """An accumulator exactly on a threshold does not cross it (strict
    comparator).  A code one step away across that threshold is an
    explained flip; two steps away, with the accumulator off the second
    threshold, is not."""
    ramp = JN.build_ramp("sigmoid", 5)
    thr = torch.from_numpy(np.asarray(ramp.thresholds, np.float32))
    y_table = torch.from_numpy(np.asarray(ramp.y_table, np.float32))
    x = torch.ones((1, 1))
    w = thr[5:6][None].clone()                 # acc == thr[5] exactly
    assert torch.equal(TFM.fused_matmul_nladc(x, w, None, thr, y_table),
                       y_table[5:6][None])
    acc, bound = TFM.accumulator_bound(x, w)
    five = torch.tensor([[5]])
    assert TFM.code_flips(five, torch.tensor([[6]]), acc, bound, thr) \
        == (1, 0)
    assert TFM.code_flips(five, five, acc, bound, thr) == (0, 0)
    assert TFM.code_flips(torch.tensor([[6]]), torch.tensor([[7]]), acc,
                          bound, thr) == (1, 1)


def test_wrapper_rejects_bad_operands():
    adc = TN.NLADC(TN.build_ramp("silu", 5))
    x, w = torch.zeros(3, 8), torch.zeros(8, 5)
    ok = (x, w, None, adc.thresholds, adc.y_table)
    TFM.fused_matmul_nladc(*ok)
    bad = [(x.double(),) + ok[1:],
           (x, w.to(torch.bfloat16)) + ok[2:],
           (x, torch.zeros(7, 5)) + ok[2:],
           (x, w, torch.zeros(4)) + ok[3:],
           (x, w, None, torch.zeros(4, 32)) + ok[4:],
           (x, w, None, adc.thresholds, torch.zeros(32)),
           (torch.zeros(8, 3).t(),) + ok[1:]]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            TFM.fused_matmul_nladc(*args)
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda").matmul_nladc(x, w, adc)


def test_backends_agree_in_float32():
    """The ``ref`` backend's function (matmul in x's dtype) and the
    kernel's (float32 operands) coincide for float32 x."""
    adc = TN.NLADC(TN.build_ramp("silu", 5))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (16, 12)).astype(np.float32))
    ref = TBK.get_backend("ref").matmul_nladc(x, w, adc)
    plain = TFM.fused_matmul_nladc(x.reshape(-1, 16), w, None,
                                   adc.thresholds, adc.y_table)
    assert torch.equal(ref.reshape(-1, 12), plain)


def test_library_declares_pointer_arguments(monkeypatch):
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        fused_matmul_nladc_launch=SimpleNamespace(argtypes=None,
                                                  restype=None),
        fused_gemm_nladc_launch=SimpleNamespace(argtypes=None, restype=None),
        moe_fused_matmul_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TFM._build, "load", lambda name: fake)
    lib = TFM.library()
    fn = lib.fused_matmul_nladc_launch
    assert fn.argtypes == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    # the tensor-core path (M > 8): x, its staged parts, w, bias, thr,
    # y_table, out; 9 ints; the stream
    fn = lib.fused_gemm_nladc_launch
    assert fn.argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    # the grouped expert gate shares the library
    fn = lib.moe_fused_matmul_launch
    assert fn.argtypes == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p


def _f32_bits(bits):
    return torch.tensor(np.asarray(bits, np.uint32).view(np.int32)).view(
        torch.float32)


def _split_cases():
    rng = np.random.default_rng(21)
    normal = rng.normal(0, 1, 4096)
    exps = np.arange(-110, 128)
    mant = 1 + rng.random(exps.size)
    # values halfway between two bfloat16 (round-to-nearest ties) from
    # 2**-110 up, and the largest float32, whose nearest bfloat16 is
    # infinity
    ties = (rng.integers(0x0880, 0x7F00, 512, dtype=np.uint32) << 16) | 0x8000
    scaled = np.concatenate([normal * 1e-30, normal * 1e30])
    return {
        "normal": torch.tensor(normal, dtype=torch.float32),
        "scaled": torch.tensor(scaled[np.abs(scaled) >= 2.0 ** -110],
                               dtype=torch.float32),
        "signed_zeros": torch.tensor([0.0, -0.0]),
        "powers_of_two": torch.tensor(np.concatenate([2.0 ** exps,
                                                      -(2.0 ** exps)]),
                                      dtype=torch.float32),
        "down_to_2^-110": torch.tensor(np.ldexp(mant, exps) * np.where(
            exps % 2, 1, -1), dtype=torch.float32),
        "bf16_ties": torch.cat([_f32_bits(ties), -_f32_bits(ties)]),
        "float32_max": torch.tensor([3.4028234663852886e38,
                                     -3.4028234663852886e38, 3.3961e38]),
    }


@pytest.mark.parametrize("case", sorted(_split_cases()))
def test_split_bf16x3_sums_to_w_exactly(case):
    """w == h1 + h2 + h3 exactly in float64, each part a bfloat16 of at most
    8 significant bits, the parts in decreasing magnitude."""
    w = _split_cases()[case]
    h = split_bf16x3(w)
    assert all(p.dtype == torch.bfloat16 for p in h)
    total = h[0].double() + h[1].double() + h[2].double()
    assert torch.equal(total, w.double())
    assert torch.all(h[1].double().abs() <= h[0].double().abs())
    assert torch.all(h[2].double().abs() <= h[1].double().abs())


def test_split_bf16x3_exactness_ends_below_2_to_the_minus_110():
    """Under 2**-110 the third part cannot hold the last bits: they are
    below bfloat16's smallest subnormal, 2**-133, and are lost."""
    w = torch.tensor([2.0 ** -111 * (1 + 2.0 ** -23)], dtype=torch.float32)
    h = split_bf16x3(w)
    err = float((h[0].double() + h[1].double() + h[2].double()
                 - w.double()).abs())
    assert 0 < err < 2.0 ** -133


def test_split_bf16x3_keeps_inf_and_nan():
    w = torch.cat([torch.tensor([float("inf"), -float("inf"), float("nan")]),
                   _f32_bits([0x7F800001, 0xFFC00000])])   # NaN payloads
    h1, h2, h3 = split_bf16x3(w)
    assert torch.equal(h1[:2].float(), w[:2])
    assert torch.isnan(h1[2:]).all()
    assert torch.equal(h2.float(), torch.zeros(5)) and \
        torch.equal(h3.float(), torch.zeros(5))
    total = h1.double() + h2.double() + h3.double()
    assert torch.equal(total[:2], w[:2].double())
    assert torch.isnan(total[2:]).all()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_split_products_are_exact_in_float32(x_dtype):
    """Every product of a bfloat16 part of x with one of w is exact in
    float32 (8 x 8 significant bits), and the products sum exactly to
    x * w: the GEMM's 3 (bfloat16 x) or 9 (float32 x) products a
    multiply-add lose nothing before the accumulation."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(0, 1, 4096), dtype=torch.float32).to(x_dtype)
    w = torch.tensor(rng.normal(0, 0.05, 4096), dtype=torch.float32)
    xs = split_bf16x3(x.float()) if x_dtype == torch.float32 else (x,)
    total = torch.zeros(4096, dtype=torch.float64)
    for xp in xs:
        for wp in split_bf16x3(w):
            prod32 = xp.float() * wp.float()
            assert torch.equal(prod32.double(), xp.double() * wp.double())
            total += prod32.double()
    assert torch.equal(total, x.double() * w.double())
