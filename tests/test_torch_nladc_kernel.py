"""The elementwise NL-ADC kernel's plain version and CPU wrapper
(``repro_torch.kernels.nladc``) against the JAX package: its Pallas
kernel (``repro.kernels.ops.nladc``, interpret mode, as the JAX tests run
it) and its ``ref`` backend (``RefBackend.nladc``).

Contract: the codes are bitwise equal to both.  Values are bitwise equal
to the JAX ``ref`` backend (both decode by table lookup); against the
Pallas kernel, which decodes in closed form, they are equal after the
bfloat16 cast and within one float32 ulp, ``2**-23 * max(1, |y|)``, in
float32.  The JAX codes come from a counting ramp (the same thresholds,
``y(n) = n``), since a table may repeat a value.

Cases: the router's shape (4, 64) in bfloat16 with one ``(P,)`` ramp;
(4, 1100) in float32 with 512-column threshold banks; a ragged float32
(33, 300) with every threshold placed exactly on an input (the strict
comparator), and a 3-D input.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.kernels import ops as JOPS
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
from repro_torch.kernels import nladc as TNK
from repro_torch.kernels.ref import thermometer_count

VALUE_RTOL = 2.0 ** -23


def _count_ramp(ramp):
    p = len(ramp.thresholds)
    return dataclasses.replace(ramp, y_table=np.arange(p + 1.0),
                               split_index=-1, monotonic_split=False)


CASES = [((4, 64), "sigmoid", "bfloat16", 0),
         ((4, 1100), "silu", "float32", 512),
         ((33, 300), "tanh", "float32", 0),
         ((2, 3, 40), "gelu", "bfloat16", 16)]


def _case(shape, name, dtype, bank_cols, seed):
    rng = np.random.default_rng(seed)
    ramp = JN.build_ramp(name, 5)
    thr64 = np.asarray(ramp.thresholds, np.float64)
    n = shape[-1]
    x = rng.normal(0, 2.5, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[: thr64.size] = thr64.astype(np.float32)    # exact hits
    if dtype == "bfloat16":                           # what bf16 can hold
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if bank_cols:
        bm_j = JN.bank_map_for(n, bank_cols)
        banks = (thr64[None, :] + rng.normal(0, 0.03, (bm_j.n_banks, 1))
                 ).astype(np.float32)
        thr_j = JN.BankedThresholds(jnp.asarray(banks), bm_j)
        thr_t = TN.BankedThresholds(torch.from_numpy(banks),
                                    TN.bank_map_for(n, bank_cols))
    else:
        thr_j = jnp.asarray(thr64.astype(np.float32))
        thr_t = torch.from_numpy(thr64.astype(np.float32))
    return ramp, x, thr_j, thr_t


@pytest.mark.parametrize("shape,name,dtype,bank_cols", CASES)
def test_plain_and_wrapper_match_jax(shape, name, dtype, bank_cols):
    ramp, x, thr_j, thr_t = _case(shape, name, dtype, bank_cols,
                                  seed=sum(shape))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.tensor(x).to(tdt)

    # JAX: Pallas codes and values, ref-backend codes and values
    pal_codes = np.asarray(JOPS.nladc(xj, _count_ramp(ramp),
                                      thresholds=thr_j).astype(jnp.float32))
    pal_y = np.asarray(JOPS.nladc(xj, ramp, thresholds=thr_j)
                       .astype(jnp.float32))
    ref = JBK.get_backend("ref")
    ref_codes = np.asarray(ref.nladc(xj, JN.NLADC(_count_ramp(ramp)),
                                     thr_j).astype(jnp.float32))
    ref_y = np.asarray(ref.nladc(xj, JN.NLADC(ramp), thr_j)
                       .astype(jnp.float32))

    thr = thr_t.per_column if bank_cols else thr_t
    y_table = torch.from_numpy(np.asarray(ramp.y_table, np.float32))
    count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32)
    n0 = TNK.nladc.launches
    y_plain = TNK.nladc_plain(xt, thr, y_table)
    y_wrap = TNK.nladc(xt, thr, y_table)
    codes = TNK.nladc(xt, thr, count).float().numpy()
    assert TNK.nladc.launches == n0          # the CPU takes the plain version
    assert y_plain.dtype == tdt and y_plain.shape == xt.shape
    assert torch.equal(y_plain, y_wrap)
    np.testing.assert_array_equal(codes,
                                  thermometer_count(xt, thr).float().numpy())

    np.testing.assert_array_equal(codes, pal_codes)
    np.testing.assert_array_equal(codes, ref_codes)
    y_t = y_plain.float().numpy()
    np.testing.assert_array_equal(y_t, ref_y)
    if dtype == "float32":
        tol = VALUE_RTOL * np.maximum(1.0, np.abs(pal_y))
        assert np.all(np.abs(y_t - pal_y) <= tol)
    else:
        np.testing.assert_array_equal(y_t, pal_y)


@pytest.mark.parametrize("bank_cols", [0, 16])
def test_activation_on_both_backends_is_the_wrapper(bank_cols):
    """``AnalogActivation.__call__`` goes through ``bk.nladc``: the ref
    backend and the kernel wrapper (its plain version here) agree
    bitwise; the cuda backend refuses a CPU tensor."""
    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       bank_cols=bank_cols, backend="ref", device="ideal")
    act = AnalogActivation("sigmoid", cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 3, (5, 40)).astype(np.float32)).bfloat16()
    thr = act.thresholds_for(40)
    dense = thr.per_column if bank_cols else thr
    want = TNK.nladc(x, dense, act.adc.y_table)
    assert torch.equal(act(x), want)
    assert torch.equal(TBK.get_backend("ref").nladc(x, act.adc, thr), want)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TBK.get_backend("cuda").nladc(x, act.adc, thr)


def test_wrapper_checks_its_arguments():
    thr = torch.linspace(-1, 1, 8)
    y = torch.arange(9.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TNK.nladc(torch.zeros(2, 3, dtype=torch.float16), thr, y)
    with pytest.raises(TypeError, match="thr must be float32"):
        TNK.nladc(torch.zeros(2, 3), thr.double(), y)
    with pytest.raises(ValueError, match=r"thr must be \(8,\) or \(3, 8\)"):
        TNK.nladc(torch.zeros(2, 3), thr.expand(4, 8).contiguous(), y)
    with pytest.raises(ValueError, match="y_table"):
        TNK.nladc(torch.zeros(2, 3), thr, y[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        TNK.nladc(torch.zeros(3, 2).T, thr, y)


def test_library_declares_pointer_arguments(monkeypatch):
    """Every pointer and the stream go through ctypes as ``c_void_p``; an
    undeclared argument would be cut to a 32-bit int."""
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        nladc_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TNK._build, "load", lambda name: fake)
    lib = TNK.library()
    assert lib.nladc_launch.argtypes == [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    assert lib.nladc_launch.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p
