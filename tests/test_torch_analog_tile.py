"""The crossbar tile (``analog_tile``): the port's CPU path against the JAX
package's Pallas kernel (``repro.kernels.ops.analog_tile``, interpret mode,
jitted with the ramp closed over, as the JAX sweep calls it), bitwise.

Both compute ``NLADC(pwm(f32(x)) @ (w + noise))`` with the closed-form
decode and cast to x's dtype.  Under ``jax.jit`` XLA multiplies by the
float32 reciprocal of the PWM step and contracts the decode's
``y0 + d * lsb`` into one FMA; the port computes exactly that, so it is
held to the jitted reference and not to eager JAX.  For float32 x the
kernel and the jnp oracle (``repro.kernels.ref.analog_tile``) are one
function; for bfloat16 x with PWM they part (the kernel quantizes in
float32, the oracle in bfloat16), and the kernel is the contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nladc as JN
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import analog_tile as TAT
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.kernels.ref import (closed_form_params, effective_operands,
                                    thermometer_count)

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

RAMPS = ("tanh", "sigmoid", "swish", "selu")   # affine x 2, V-shape, signed
SHAPES = ((50, 72, 128), (1, 33, 7))


def _inputs(shape, dtype, noise, seed=0):
    *lead, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.6, (*lead, k)).astype(np.float32)
    if dtype == "bfloat16":      # values the bf16 operand can hold
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(0, 2.0 / np.sqrt(k), (k, n)).astype(np.float32)
    nz = rng.normal(0, 0.02, (k, n)).astype(np.float32) if noise else None
    return x, w, nz


def _jax(fn, x, w, nz, ramp, bits, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    call = jax.jit(lambda a, b, c: fn(a, b, ramp, input_bits=bits,
                                      w_noise=c))
    out = call(jnp.asarray(x, jdt), jnp.asarray(w),
               None if nz is None else jnp.asarray(nz))
    assert out.dtype == jdt
    return np.asarray(out.astype(jnp.float32))


def _port(x, w, nz, ramp, bits, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    thr = torch.from_numpy(np.asarray(ramp.thresholds, np.float32))
    out = TAT.analog_tile(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                          thr, closed_form_params(ramp),
                          w_noise=None if nz is None else
                          torch.from_numpy(nz), input_bits=bits)
    assert out.dtype == tdt
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", RAMPS)
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("bits", [3, 4, 5, 8, None])
def test_cpu_path_equals_pallas_kernel(bits, noise, name, dtype):
    ramp = JN.build_ramp(name, 5)
    for shape in SHAPES:
        x, w, nz = _inputs(shape, dtype, noise, seed=bits or 0)
        want = _jax(JOPS.analog_tile, x, w, nz, ramp, bits, dtype)
        got = _port(x, w, nz, ramp, bits, dtype)
        np.testing.assert_array_equal(got, want)
        if dtype == "float32":     # kernel and jnp oracle are one function
            np.testing.assert_array_equal(
                got, _jax(JREF.analog_tile, x, w, nz, ramp, bits, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leading_batch_dims(dtype):
    ramp = JN.build_ramp("swish", 5)
    x, w, nz = _inputs((2, 3, 40, 24), dtype, True, seed=5)
    want = _jax(JOPS.analog_tile, x, w, nz, ramp, 5, dtype)
    got = _port(x, w, nz, ramp, 5, dtype)
    assert got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 5])
def test_pwm_half_step_boundaries(bits):
    """x at every PWM half-step and one and two float32 ulps either side,
    where a division by the step and the jitted multiplication by its
    reciprocal part."""
    levels = (1 << bits) - 2
    half = ((np.arange(-(levels // 2), levels // 2) + 0.5) * 2.0 / levels)
    vals = []
    for h in half.astype(np.float32):
        u, d = h, h
        vals.append(h)
        for _ in range(2):
            u, d = np.nextafter(u, np.float32(2)), np.nextafter(
                d, np.float32(-2))
            vals += [u, d]
    k = len(vals)
    x = np.asarray(vals, np.float32).reshape(1, k).repeat(3, 0)
    x[1] = x[1][::-1]
    x[2] = -x[2]
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 1.0 / np.sqrt(k), (k, 40)).astype(np.float32)
    ramp = JN.build_ramp("tanh", 5)
    want = _jax(JOPS.analog_tile, x, w, None, ramp, bits, "float32")
    np.testing.assert_array_equal(
        _port(x, w, None, ramp, bits, "float32"), want)


def test_eager_reference_is_not_the_contract():
    """Eager JAX divides by the step and rounds y0 + d*lsb twice; the
    jitted reference (and the Pallas kernel) do neither, and the port
    follows them."""
    ramp = JN.build_ramp("tanh", 5)
    x, w, nz = _inputs((50, 72, 128), "float32", True)
    jitted = _jax(JREF.analog_tile, x, w, nz, ramp, 5, "float32")
    with jax.disable_jit():
        eager = np.asarray(JREF.analog_tile(
            jnp.asarray(x), jnp.asarray(w), ramp, input_bits=5,
            w_noise=jnp.asarray(nz)))
    assert (eager != jitted).any()
    np.testing.assert_array_equal(_port(x, w, nz, ramp, 5, "float32"),
                                  jitted)


def test_bf16_pwm_follows_the_kernel_not_the_jnp_oracle():
    ramp = JN.build_ramp("tanh", 5)
    x, w, nz = _inputs((50, 72, 128), "bfloat16", False)
    kernel = _jax(JOPS.analog_tile, x, w, nz, ramp, 5, "bfloat16")
    oracle = _jax(JREF.analog_tile, x, w, nz, ramp, 5, "bfloat16")
    assert (kernel != oracle).any()
    np.testing.assert_array_equal(_port(x, w, nz, ramp, 5, "bfloat16"),
                                  kernel)


@pytest.mark.parametrize("bits", [3, None])
def test_code_flips_on_the_effective_operands(bits):
    """The card's contract: codes against the float64 accumulator of the
    effective operands pwm(x) and w + noise, which equal the reference's."""
    ramp = JN.build_ramp("selu", 5)
    x, w, nz = _inputs((33, 300, 100), "float32", True, seed=9)
    xq, w_eff = effective_operands(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(nz), bits)
    want_xq = x if bits is None else np.asarray(jax.jit(
        JN.pwm_quantize, static_argnums=(1, 2))(jnp.asarray(x), bits, 1.0))
    np.testing.assert_array_equal(xq.numpy(), want_xq)
    np.testing.assert_array_equal(w_eff.numpy(), w + nz)
    thr = torch.from_numpy(np.asarray(ramp.thresholds, np.float32))
    codes = thermometer_count(xq @ w_eff, thr)
    acc, bound = TFM.accumulator_bound(xq, w_eff)
    exact = thermometer_count(acc, thr.double())
    flips, unexplained = TFM.code_flips(codes, exact, acc, bound, thr)
    assert unexplained == 0 and flips <= 0.01 * codes.numel()


def test_wrapper_rejects_bad_operands():
    ramp = JN.build_ramp("tanh", 5)
    dec = closed_form_params(ramp)
    thr = torch.from_numpy(np.asarray(ramp.thresholds, np.float32))
    x, w = torch.zeros(4, 8), torch.zeros(8, 5)
    with pytest.raises(ValueError, match=r"\(P,\)"):
        TAT.analog_tile(x, w, thr.expand(5, -1).contiguous(), dec)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TAT.analog_tile(x.double(), w, thr, dec)
    with pytest.raises(TypeError, match="w must be float32"):
        TAT.analog_tile(x, w.bfloat16(), thr, dec)
    with pytest.raises(ValueError, match="do not match"):
        TAT.analog_tile(x, torch.zeros(7, 5), thr, dec)
    with pytest.raises(ValueError, match="w_noise"):
        TAT.analog_tile(x, w, thr, dec, w_noise=torch.zeros(8, 4))
    with pytest.raises(ValueError, match="no kernel for meta"):
        TAT.analog_tile(x.to("meta"), w.to("meta"), thr.to("meta"), dec)
    n0 = TAT.analog_tile.launches
    TAT.analog_tile(x, w, thr, dec, input_bits=5)
    assert TAT.analog_tile.launches == n0      # the CPU takes the plain path


def test_library_declares_argument_types(monkeypatch):
    """Pointers and the stream go through ctypes as ``c_void_p`` (an
    undeclared one would be cut to 32 bits), the PWM and decode constants
    as ``c_float``."""
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        analog_tile_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TAT._build, "load", lambda name: fake)
    lib = TAT.library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert lib.analog_tile_launch.argtypes == [p] * 5 + [i] * 6 + [f] * 3 \
        + [i] * 2 + [f] * 3 + [i] * 4 + [p]
    assert lib.analog_tile_launch.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p



@pytest.mark.parametrize("m,n,rows,cols,sms", [
    (16, 8064, 16, 32, 132),      # the PTB crossbar: 252 strips
    (16, 8064, 16, 64, 132),      # 126 strips, 6 SMs idle
    (128, 256, 4, 32, 132),       # the sweep's: 32 x 8 items
    (33, 1000, 8, 64, 132),       # ragged rows and columns
    (1, 7, 4, 32, 132),           # one item
    (50, 128, 16, 32, 3)])        # more items than CTAs, unevenly
def test_persistent_schedule_covers_every_item_once(m, n, rows, cols, sms):
    """The crossbar tile's static schedule (csrc/analog_tile.cu: CTA c of
    ctas takes items c, c + ctas, ...; item i is row block i // strips,
    strip i % strips) over the wrapper's CTA count: at most one CTA per SM
    and no more CTAs than work items, and the CTAs' item lists together
    hold every (row block, strip) exactly once, each CTA's in ascending
    order."""
    ctas = TAT.persistent_ctas(m, n, rows, cols, sms)
    blocks, strips = -(-m // rows), -(-n // cols)
    assert 1 <= ctas <= min(sms, blocks * strips)
    lists = [[divmod(i, strips) for i in range(c, blocks * strips, ctas)]
             for c in range(ctas)]
    seen = [item for lst in lists for item in lst]
    assert sorted(seen) == [(b, s) for b in range(blocks)
                            for s in range(strips)]
    assert all(lst == sorted(lst) and lst for lst in lists)
    sizes = [len(lst) for lst in lists]
    assert max(sizes) - min(sizes) <= 1          # balanced to one item
