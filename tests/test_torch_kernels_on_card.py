"""The LM path's kernels on the card, against their plain versions.

This file imports nothing of JAX, so it runs on a GPU host that has only
PyTorch: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_kernels_on_card.py``.  Without a GPU every test skips.

* ``fused_matmul_nladc``: the kernel's codes (read from a launch with the
  counting table ``y(n) = n``) equal the plain version's except where the
  float64 accumulator lies within the float32 summation bound of a crossed
  threshold (at most 1% of outputs); its outputs are the table at its
  codes.  SMOKE shapes and the serving path's (4 and 1 rows, K 2048,
  N 11008), flat and banked thresholds, float32 and bfloat16 x; at M > 8
  (the tensor-core GEMM) the SMOKE (33, 40, 24), and in bfloat16 (64,
  2048, 11008), a ragged (130, 300, 1000) (x staged: K x 2 bytes is no
  multiple of 16) and the training shapes (512 and 1024, 2048, 11008: a
  microbatch of 4 rows and the monolithic step); whisper-base's
  gelu gate (K 512, N 2048) at M 4 and M 6000.  Every GEMM
  config computes the default's bits, and a microbatch's rows the bits
  the monolithic call gives them; at M <= 8 (the GEMV) the outputs
  are the bits the GEMV computed before the GEMM existed (stored crc32
  digests).
* ``prefill_attention``: max abs diff 1e-6 in float32, one bfloat16 ulp in
  bfloat16, ragged masks with a row that sees a single slot, at a SMOKE
  shape and the serving path's, S not a multiple of the cluster's split,
  S 1, 448 (whisper-base's text context) and 2048, G 1, 8 and 16, D 64
  and 256; the full local window (S
  2048, G 16, D 256: float32 V streams through the kernel's ring of two
  boxes; bfloat16 within one ulp or 1e-5); and every cluster size
  computes the same bits.
* ``nladc``: bitwise equal to its plain version (codes and values), at
  the router's shape (4, 64) bfloat16, the (4, 11008) bfloat16 width with
  512-column threshold banks, and a ragged float32 (33, 1000); NaN counts
  0 and +-inf all or none, flat and banked.
* ``moe_fused_matmul``: ``fused_matmul_nladc``'s contract over the expert
  axis, at the moonshot expert gate's shape (64 experts, C 6, d 2048,
  f 1408, bfloat16 x, flat and banked-512) and a ragged float32
  (5, 7, 300, 1000); at the gate's shape with every expert live, none
  live, the serving fill (x from ``dispatch_plan`` and
  ``gather_expert_buffer`` at B 4, top-6) and an expert with one live row
  among zeros, where empty experts' outputs are the table at the zero
  code.
* ``flash_decode_int8``: max abs diff 1e-5 against its plain version at
  the moonshot serving shape (B 4, H = Hkv = 16, D 128, S 128), a GQA case
  (H 16, Hkv 2) and ragged S and lengths; for every split count (1 to 8
  CTAs a cluster) with rows of length 0 and lengths no multiple of a tile,
  at D 16, 64, 128 and 256; and two launches on the same inputs give the
  same bits.
* ``analog_tile``: the fused matmul's flip contract on the effective
  operands ``pwm(x)`` and ``w + noise`` (at most 1%), outputs equal to the
  closed-form decode at the kernel's codes; PWM widths 3, 5, 8 and none,
  with and without read noise, the three decode modes, float32 and
  bfloat16 x, ragged shapes, the PTB gate crossbar (16, 632, 8064) and the
  JAX sweep's (128, 256, 256); on the same cases every (rows, cols, ring
  depth) computes the default config's bits.
* ``lstm_gates``: bitwise equal to its plain version (NaN where it has
  NaN), flat and banked, P 7, 15 and 31 (template instances) and 12 (the
  run-time instance), B 1, 7, 16 and 33, H a multiple of the strip, ragged,
  and with H x P x 4 or a threshold pointer not 16-byte aligned (the plain
  copy beside the bulk copy); NaN, +-inf and values exactly on thresholds
  in the gates and in c.
* ``lstm_gates_bwd`` (the tail's straight-through backward): its five
  rematerialized codes bitwise the forward kernel's, and ``(d_gates, d_c)``
  within 4 float32 ulps of its plain version (expf / tanhf against
  torch's sigmoid / tanh on the card, through a chain of two products), NaN
  where it has NaN; flat and banked, P 8, 16, 32 and 7, B 1, 7, 16, 33 and
  64; NaN, +-inf and values on thresholds in the gates and in c, gates
  exactly on the ramps' domain edges, infinite cotangents.
* ``nladc``, the same way: flat and banked, P 7, 15, 31 and 12, float32 and
  bfloat16, M 1, 4 and 33, rows aligned to 16 bytes and not, a threshold
  pointer not 16-byte aligned.
* The launch floor writes its word.
* The tune seam: every sweep candidate of every tunable kernel (the expert
  gate's among them) computes the default config's bits, on the sweep's
  flat ramps and on banked thresholds for the two elementwise kernels, and
  a cache miss launches the default config.
* The SMOKE LMs in float32 on the ``cuda`` and ``ref`` backends
  (qwen2.5-3b; moonshot-v1-16b-a3b with an int8 KV cache): logits within
  LSB/2 of the silu ramp, and each kernel of the path launched once per
  layer per step.
* The ``cuda`` backend's autograd Functions (the NL-ADC, the fused gate
  with and without a bias, the expert gate, the cached attention): with
  an input that requires a gradient the output carries a ``grad_fn`` and
  the kernel launches once; the gradients equal the ``ref`` backend's on
  the card within rtol and atol 1e-5 in float32 (both recompute the same
  accumulator in plain torch), non-zero; without a gradient no graph.
* The SMOKE LMs' train-mode loss and gradients on the ``cuda`` backend
  against ``ref`` (same weights, same generator state), rtol 2e-4 / atol
  2e-5, each gate kernel launched twice per layer (``remat``); and on the
  ``cuda`` backend alone, bitwise equal under every ``remat_policy``
  (full, dots, none), recurrentgemma's group and tail too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import nladc as TN
from repro_torch.kernels import analog_tile as TAT
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.kernels import launch_floor as TLF
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.kernels import nladc as TNK
from repro_torch.kernels import prefill_attention as TPA
from repro_torch.kernels import tune as TT
from repro_torch.kernels.ref import (ClosedForm, closed_form_decode_fma,
                                    closed_form_params, effective_operands,
                                    thermometer_count, ulp_distance)
from repro_torch.launch.common import configure_numerics
from repro_torch.nn.model import build

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

MAX_FLIP_SHARE = 0.01
F32_ATOL = 1e-6
FLASH_ATOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    configure_numerics()
    return torch.device("cuda")


MATMUL_CASES = [(m, k, n, name, dt, bias, tiles)
                for (m, k, n) in [(33, 40, 24), (4, 64, 160), (4, 2048, 11008),
                                  (1, 2048, 11008)]
                for name in ("sigmoid", "silu")
                for dt in (torch.float32, torch.bfloat16)
                for bias, tiles in [(False, 0), (True, 16), (False, 512)]]
# the tensor-core GEMM (M > 8) at the LM's widths, bfloat16 x
MATMUL_CASES += [(m, k, n, name, torch.bfloat16, bias, tiles)
                 for (m, k, n) in [(64, 2048, 11008), (130, 300, 1000),
                                   (512, 2048, 11008), (1024, 2048, 11008)]
                 for name in ("sigmoid", "silu")
                 for bias, tiles in [(False, 0), (True, 16), (False, 512)]]
# the dense configs' MLP gates at serving rows (the GEMV), bfloat16 x:
# granite-3-8b, qwen2.5-32b, pixtral-12b (silu) and granite-34b (gelu)
MATMUL_CASES += [(m, k, n, name, torch.bfloat16, False, tiles)
                 for (k, n, name) in [(4096, 12800, "silu"),
                                      (5120, 27648, "silu"),
                                      (5120, 14336, "silu"),
                                      (6144, 24576, "gelu")]
                 for m in (4, 1) for tiles in (0, 512)]
# whisper-base's MLP gate (K 512, N 2048, gelu), bfloat16 x: the decode
# GEMV (M 4) and the encoder's GEMM over 4 x 1500 frames (a ragged last
# tile)
MATMUL_CASES += [(m, 512, 2048, "gelu", torch.bfloat16, False, 0)
                 for m in (4, 6000)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,name,dtype,bias,tile_cols", MATMUL_CASES)
def test_fused_matmul_kernel_matches_plain(m, k, n, name, dtype, bias,
                                           tile_cols):
    dev = _card()
    rng = np.random.default_rng(m * 100_000 + n)
    ramp = TN.build_ramp(name, 5)
    x = torch.tensor(rng.normal(0, 1.0, (m, k)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 2.0 / np.sqrt(k), (k, n)),
                     dtype=torch.float32)
    b = torch.tensor(rng.normal(0, 0.5, (n,)), dtype=torch.float32) \
        if bias else None
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32)
    if tile_cols and n > tile_cols:
        bm = TN.bank_map_for(n, tile_cols)
        banks = thr[None] + torch.tensor(
            rng.normal(0, 0.03, (bm.n_banks, 1)), dtype=torch.float32)
        thr = TN.BankedThresholds(banks, bm).per_column
    x, w, thr = x.to(dev, dtype), w.to(dev), thr.to(dev)
    b = b.to(dev) if b is not None else None
    y_table = torch.tensor(ramp.y_table, dtype=torch.float32, device=dev)
    count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32, device=dev)

    n0 = TFM.fused_matmul_nladc.launches
    yk = TFM.fused_matmul_nladc(x, w, b, thr, y_table)
    nk = TFM.fused_matmul_nladc(x, w, b, thr, count).long()
    torch.cuda.synchronize()
    assert TFM.fused_matmul_nladc.launches == n0 + 2
    assert yk.dtype == dtype and torch.equal(yk, y_table[nk].to(dtype))
    n_plain = thermometer_count(x.float() @ w + (b if bias else 0.0), thr)
    acc, bound = TFM.accumulator_bound(x, w, b)
    flips, unexplained = TFM.code_flips(nk, n_plain, acc, bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * nk.numel()


def _matmul_inputs(m, k, n, name, dtype, bias, tile_cols, seed):
    """Seeded numpy inputs of one fused-matmul call, on the CPU: x (M, K)
    in ``dtype``, w (K, N), bias or None, (P,) or banked (N, P)
    thresholds, the ramp's y table."""
    rng = np.random.default_rng(seed)
    ramp = TN.build_ramp(name, 5)
    x = torch.tensor(rng.normal(0, 1.0, (m, k)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 2.0 / np.sqrt(k), (k, n)),
                     dtype=torch.float32)
    b = torch.tensor(rng.normal(0, 0.5, (n,)), dtype=torch.float32) \
        if bias else None
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32)
    if tile_cols and n > tile_cols:
        bm = TN.bank_map_for(n, tile_cols)
        banks = thr[None] + torch.tensor(
            rng.normal(0, 0.03, (bm.n_banks, 1)), dtype=torch.float32)
        thr = TN.BankedThresholds(banks, bm).per_column.contiguous()
    y_table = torch.tensor(ramp.y_table, dtype=torch.float32)
    return x.to(dtype), w, b, thr, y_table


# The GEMV's (M <= 8) output digests (kernels/tune.py::digest, crc32 of the
# float32 bytes) on _matmul_inputs(*case, seed=3), computed by the GEMV as
# it was before the M > 8 GEMM was added, on an H100: its bits must not move
GEMV_DIGESTS = {
    "1-2048-11008-silu-bfloat16-nobias-0": "8d88086a",
    "2-40-24-sigmoid-bfloat16-nobias-0": "a2894e6a",
    "3-300-1000-silu-float32-bias-0": "69d779b0",
    "4-2048-11008-silu-bfloat16-nobias-0": "890cd848",
    "4-2048-11008-silu-bfloat16-nobias-512": "91925c2f",
    "8-64-160-sigmoid-float32-bias-16": "946d9d4b",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEMV_DIGESTS))
def test_gemv_rows_keep_their_earlier_bits(case):
    dev = _card()
    m, k, n, name, dtype, bias, tiles = case.split("-")
    args = _matmul_inputs(int(m), int(k), int(n), name,
                          getattr(torch, dtype), bias == "bias", int(tiles),
                          seed=3)
    args = [a.to(dev) if a is not None else None for a in args]
    n0 = TFM.fused_matmul_nladc.launches
    out = TFM.fused_matmul_nladc(*args)
    assert TFM.fused_matmul_nladc.launches == n0 + 1
    assert TT.digest(out) == GEMV_DIGESTS[case]


GEMM_CONFIG_CASES = [(1024, 2048, 11008, "silu", torch.bfloat16, False, 512),
                     (130, 300, 1000, "sigmoid", torch.bfloat16, True, 16),
                     (130, 300, 1000, "silu", torch.float32, True, 0),
                     (64, 2048, 11008, "silu", torch.float32, False, 512),
                     (33, 40, 24, "silu", torch.float32, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cols", [0, 512])
def test_gemm_rows_keep_their_bits_in_a_microbatch(tile_cols):
    """The monolithic train step's gate (1024, 2048, 11008) and the same
    rows as two microbatches of 512 (``grad_accum_step``'s): each row
    sums its K in one order whatever M, so the halves are bitwise the
    monolithic call's rows."""
    dev = _card()
    args = [a.to(dev) if a is not None else None for a in _matmul_inputs(
        1024, 2048, 11008, "silu", torch.bfloat16, False, tile_cols,
        seed=7)]
    x, rest = args[0], args[1:]
    want = TFM.fused_matmul_nladc(x, *rest)
    got = torch.cat([TFM.fused_matmul_nladc(x[i:i + 512], *rest)
                     for i in (0, 512)])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,name,dtype,bias,tile_cols",
                         GEMM_CONFIG_CASES)
def test_every_gemm_config_computes_the_default_bits(m, k, n, name, dtype,
                                                     bias, tile_cols):
    """Every (rows, cols, stages) of the M > 8 GEMM gives the default
    config's bits: each output sums its K in one order whatever the tile
    or the ring depth."""
    dev = _card()
    args = [a.to(dev) if a is not None else None for a in _matmul_inputs(
        m, k, n, name, dtype, bias, tile_cols, seed=m + n)]
    shape = (m, k, n)
    want = TFM.fused_matmul_nladc(*args, blocks=TT.GEMM_BLOCKS)
    cands = TT.candidates("fused_matmul_nladc", shape)
    assert len(cands) > 1 and all(c[0] >= 64 for c in cands)
    for blocks in cands:
        got = TFM.fused_matmul_nladc(*args, blocks=blocks)
        assert torch.equal(got, want), blocks


def _bf16_ulp(a):
    a = a.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


ATTN_CASES = [  # b, s, h, hkv, d
    (3, 12, 8, 2, 16),         # SMOKE
    (4, 128, 16, 2, 128),      # the serving shape
    (4, 100, 16, 2, 128),      # S not a multiple of the split (13 a CTA)
    (2, 1, 16, 2, 128),        # S 1
    (4, 2048, 16, 2, 128),     # S 2048
    (2, 96, 16, 16, 64),       # G 1, D 64
    (4, 448, 8, 8, 64),        # whisper-base's decoder: G 1, D 64, S 448
    (2, 130, 16, 1, 256)]      # G 16, D 256
# the groups the kernel takes in chunks, and qwen2.5-32b's G 5
GROUP_CASES = [  # b, s, h, hkv, d
    (4, 128, 48, 1, 128),      # granite-34b: G 48, three chunks of 16
    (4, 2048, 48, 1, 128),     # ... over a long cache
    (4, 128, 40, 8, 128),      # qwen2.5-32b: G 5
    (4, 2048, 40, 8, 128),
    (2, 50, 20, 1, 64)]        # G 20: two chunks of 10


def _attention_inputs(dev, dtype, b, s, h, hkv, d):
    rng = np.random.default_rng(s * 31 + d)
    q, k, v = (torch.tensor(rng.normal(0, 1.0, shape), dtype=torch.float32)
               .to(dev, dtype)
               for shape in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    lengths = torch.tensor(rng.integers(1, s + 1, size=b), device=dev)
    lengths[0] = s
    lengths[-1] = 1                               # a row that sees one slot
    mask = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(
        torch.int32)
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", ATTN_CASES)
def test_prefill_attention_kernel_matches_plain(dtype, b, s, h, hkv, d):
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, b, s, h, hkv, d)
    n0 = TPA.prefill_attention.launches
    got = TPA.prefill_attention(q, k, v, mask).float()
    want = TPA.prefill_attention_plain(q, k, v, mask).float()
    torch.cuda.synchronize()
    assert TPA.prefill_attention.launches == n0 + 1
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= F32_ATOL
    else:
        assert bool((diff <= _bf16_ulp(torch.maximum(got.abs(),
                                                     want.abs()))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", GROUP_CASES)
def test_prefill_attention_at_any_group_explains_its_differences(
        dtype, b, s, h, hkv, d):
    """The groups granite-34b and qwen2.5-32b give (and one of 20): every
    output past the contract (1e-6 in float32, one bfloat16 ulp) is
    explained by float32 rounding (``explained_differences``: float32
    within 1e-6 of the float64 evaluation of the same steps; bfloat16
    within the move of the probabilities that round either way), and at
    most 1% of them are past it."""
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, b, s, h, hkv, d)
    n0 = TPA.prefill_attention.launches
    got = TPA.prefill_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert TPA.prefill_attention.launches == n0 + 1
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    res = TPA.explained_differences(q, k, v, mask, got)
    assert res["unexplained"] == 0, res
    assert res["beyond"] <= MAX_FLIP_SHARE * res["outputs"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_attention_at_the_full_local_window(dtype):
    """recurrentgemma's local attention at its published window (S 2048,
    G 16, D 256).  In float32 no cluster stages V whole, so it streams
    through the kernel's ring of two boxes (cluster 16): within 1e-6.
    bfloat16 (V staged): within one ulp or 1e-5, as the outputs near 0
    move a few of their ulps with the 2048-slot sum's order."""
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, 4, 2048, 16, 1, 256)
    assert TPA.cluster_size(16, 1, 256, 2048, dtype) == 16
    got = TPA.prefill_attention(q, k, v, mask).float()
    want = TPA.prefill_attention_plain(q, k, v, mask).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= F32_ATOL
    else:
        ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
        assert bool((diff <= torch.clamp_min(ulp, 1e-5)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [(4, 128, 16, 2, 128),
                                         (3, 37, 16, 1, 256),
                                         (4, 128, 48, 1, 128)])
def test_every_cluster_size_computes_the_same_bits(dtype, b, s, h, hkv, d):
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, b, s, h, hkv, d)
    want = TPA._launch(q, k, v, mask, 1)
    for cs in (2, 4, 8, 16):
        got = TPA._launch(q, k, v, mask, cs)
        assert torch.equal(got, want), cs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_heads_every_cluster_size_computes_the_same_bits(dtype):
    """whisper-base's decoder attention (H 8 over Hkv 8: a group of 1, D
    64, S 448): every cluster the kernel takes gives the same bits.  A
    CTA's slice of V must be a whole number of 16 bytes (bfloat16: up to
    8 CTAs) and its shared memory must fit (float32: from 2 CTAs; one
    would stage 255,232 B); the wrapper's choice is one of them."""
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, 4, 448, 8, 8, 64)
    elem = q.element_size()
    sizes = [cs for cs in (1, 2, 4, 8, 16)
             if TPA._cluster_fits(1, 64, 448, cs, elem)]
    assert sizes == ([1, 2, 4, 8] if elem == 2 else [2, 4, 8, 16])
    assert TPA.cluster_size(8, 8, 64, 448, dtype) in sizes
    want = TPA._launch(q, k, v, mask, sizes[0])
    for cs in sizes[1:]:
        assert torch.equal(TPA._launch(q, k, v, mask, cs), want), cs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [(4, 128, 48, 1, 128),
                                         (2, 300, 40, 2, 128)])
def test_a_chunk_of_the_group_computes_its_own_bits(dtype, b, s, h, hkv, d):
    """A group of more than 16 heads runs in chunks, each its own cluster:
    every chunk gives the bits of a launch over its heads alone (an
    unchunked group of at most 16 over the same K and V)."""
    dev = _card()
    q, k, v, mask = _attention_inputs(dev, dtype, b, s, h, hkv, d)
    got = TPA.prefill_attention(q, k, v, mask)
    g = h // hkv
    gc = TPA.chunk_heads(g)
    assert gc <= 16
    qg = q.reshape(b, hkv, g, d)
    for c in range(-(-g // gc)):         # the last chunk may be smaller
        heads = slice(c * gc, min(g, (c + 1) * gc))
        for kv in range(hkv):
            part = TPA.prefill_attention(
                qg[:, kv, heads].contiguous(),
                k[:, :, kv:kv + 1].contiguous(),
                v[:, :, kv:kv + 1].contiguous(), mask)
            want = got.reshape(b, hkv, g, d)[:, kv, heads]
            assert torch.equal(part, want), (c, kv)


def _thresholds(rng, ramp, n, tile_cols):
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32)
    if tile_cols and n > tile_cols:
        bm = TN.bank_map_for(n, tile_cols)
        banks = thr[None] + torch.tensor(
            rng.normal(0, 0.03, (bm.n_banks, 1)), dtype=torch.float32)
        thr = TN.BankedThresholds(banks, bm).per_column
    return thr


@pytest.mark.cuda
@pytest.mark.parametrize("shape,name,dtype,tile_cols", [
    ((4, 64), "sigmoid", torch.bfloat16, 0),
    ((4, 11008), "silu", torch.bfloat16, 512),
    ((33, 1000), "tanh", torch.float32, 0),
    ((2, 3, 40), "gelu", torch.float32, 16)])
def test_nladc_kernel_matches_plain(shape, name, dtype, tile_cols):
    dev = _card()
    rng = np.random.default_rng(shape[-1])
    ramp = TN.build_ramp(name, 5)
    thr = _thresholds(rng, ramp, shape[-1], tile_cols).to(dev)
    x = torch.tensor(rng.normal(0, 2.5, shape), dtype=torch.float32)
    flat = x.view(-1)
    flat[: thr.shape[-1]] = thr.reshape(-1, thr.shape[-1])[0].cpu()
    x = x.to(dev, dtype)
    y_table = torch.tensor(ramp.y_table, dtype=torch.float32, device=dev)
    count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32, device=dev)
    n0 = TNK.nladc.launches
    yk = TNK.nladc(x, thr, y_table)
    nk = TNK.nladc(x, thr, count)
    torch.cuda.synchronize()
    assert TNK.nladc.launches == n0 + 2
    assert yk.dtype == dtype and yk.shape == x.shape
    assert torch.equal(yk, TNK.nladc_plain(x, thr, y_table))
    assert torch.equal(nk.float(), thermometer_count(x, thr).float())


@pytest.mark.cuda
@pytest.mark.parametrize("banked", [False, True])
def test_nladc_kernel_counts_nan_and_inf_as_its_plain_version(banked):
    """NaN compares false with every threshold, so the kernel's count is 0
    there, as its plain version's and the Pallas kernel's
    (tests/test_torch_nladc_nonfinite.py); +inf crosses all, -inf none."""
    dev = _card()
    thr = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    x = torch.tensor([[float("nan"), float("inf"), float("-inf"), 0.5]],
                     device=dev)
    if banked:
        thr = thr.expand(x.shape[-1], -1).contiguous()
    count = torch.arange(4, dtype=torch.float32, device=dev)
    got = TNK.nladc(x, thr, count)
    torch.cuda.synchronize()
    assert got.cpu().tolist() == [[0.0, 3.0, 0.0, 2.0]]
    assert torch.equal(got, TNK.nladc_plain(x, thr, count))


def _same_bits(got, want):
    """Bitwise equal, NaN where the other has NaN (any payload)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    if g.dtype == torch.bfloat16:
        g, w = g.view(torch.int16), w.view(torch.int16)
    else:
        g, w = g.view(torch.int32), w.view(torch.int32)
    assert torch.equal(g, w)


def _unaligned(a, dev):
    """``a`` on the card at an address 4 bytes past a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def _ramp_thresholds(rng, p, h, banked):
    """P sorted levels (one at 0.0), per column with programming noise
    (unsorted rows) where banked."""
    thr = np.sort(rng.normal(0, 1.5, p))
    thr[p // 2] = 0.0
    if banked:
        thr = thr[None] + rng.normal(0, 0.05, (h, p))
        thr[:, p // 2] = 0.0
    return thr.astype(np.float32)


def _lstm_inputs(b, h, p, banked, seed):
    """Gates, c, thresholds and tables (numpy) with the edge cases: in row
    0 every gate exactly on a threshold, in row 1 c' = fma(f, 0, i * 0)
    = 0.0 on the tanh ramp's 0.0 level, in the last row NaN and +-inf in
    each gate and in c."""
    rng = np.random.default_rng(seed)
    st, tt = (_ramp_thresholds(rng, p, h, banked) for _ in range(2))
    sy, ty = (rng.normal(0, 1, p + 1).astype(np.float32) for _ in range(2))
    ty[0] = 0.0
    gates = rng.normal(0, 2.0, (b, 4 * h)).astype(np.float32)
    c = rng.normal(0, 1.5, (b, h)).astype(np.float32)
    cols = np.arange(h)
    for g, thr in enumerate((st, tt, st, st)):
        gates[0, g * h + cols] = thr[cols, cols % p] if banked else \
            thr[cols % p]
    if b > 1:
        gates[1, h:2 * h] = -np.inf          # a's code 0: a = 0.0
        c[1] = 0.0
    special = np.array([np.nan, np.inf, -np.inf], np.float32)
    for g in range(4):
        j = cols[cols % 4 == g]
        gates[-1, g * h + j] = special[(j // 4) % 3]
    j = cols[cols % 5 == 0]
    c[-1, j] = special[(j // 5) % 3]
    return gates, c, st, sy, tt, ty


LSTM_CASES = [(b, h, p, banked)
              for b, h in [(1, 32), (7, 40), (16, 2016), (33, 100)]
              for p in (8, 16, 32, 7)
              for banked in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,p,banked", LSTM_CASES)
def test_lstm_gates_kernel_matches_plain_bitwise(b, h, p, banked):
    dev = _card()
    args = [torch.from_numpy(a).to(dev)
            for a in _lstm_inputs(b, h, p, banked, b * 1000 + h + p)]
    n0 = TLC.lstm_gates.launches
    got = TLC.lstm_gates(*args)
    want = TLC.lstm_gates_plain(*args)
    torch.cuda.synchronize()
    assert TLC.lstm_gates.launches == n0 + 1
    for g, w in zip(got, want):
        _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 32])
@pytest.mark.parametrize("banked", [False, True])
def test_lstm_gates_kernel_copies_unaligned_thresholds(p, banked):
    """Threshold and table pointers 4 bytes past a 16-byte boundary take
    the plain copy; the bits do not change."""
    dev = _card()
    gates, c, st, sy, tt, ty = (torch.from_numpy(a).to(dev) for a in
                                _lstm_inputs(16, 2016, p, banked, p))
    want = TLC.lstm_gates(gates, c, st, sy, tt, ty)
    got = TLC.lstm_gates(gates, c, *(_unaligned(a, dev)
                                     for a in (st, sy, tt, ty)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same_bits(g, w)


BWD_ULPS = 4
SIG_DOMAIN, TANH_DOMAIN = (-3.496, 3.496), (-1.749, 1.749)
LSTM_BWD_CASES = [(b, h, p, banked)
                  for b, h in [(1, 32), (7, 40), (16, 2016), (33, 100),
                               (64, 32)]
                  for p in (8, 16, 32, 7)
                  for banked in (False, True)]


def _lstm_bwd_inputs(b, h, p, banked, seed):
    """:func:`_lstm_inputs` plus cotangents, with the gates of row 2 on the
    ramps' domain edges (float32) and infinite cotangents in the last
    column."""
    gates, c, st, sy, tt, ty = _lstm_inputs(b, h, p, banked, seed)
    rng = np.random.default_rng(seed + 1)
    if b > 3:
        for g, (lo, hi) in enumerate((SIG_DOMAIN, TANH_DOMAIN, SIG_DOMAIN,
                                      SIG_DOMAIN)):
            gates[2, g * h:(g + 1) * h] = np.where(
                np.arange(h) % 2, np.float32(lo), np.float32(hi))
    ct_h = rng.normal(0, 1, (b, h)).astype(np.float32)
    ct_c = rng.normal(0, 1, (b, h)).astype(np.float32)
    ct_h[0, -1], ct_c[-1, -1] = np.inf, -np.inf
    return gates, c, st, sy, tt, ty, ct_h, ct_c


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,p,banked", LSTM_BWD_CASES)
def test_lstm_gates_bwd_kernel_matches_plain(b, h, p, banked):
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in
            _lstm_bwd_inputs(b, h, p, banked, b * 1000 + h + p)]
    gates, c, st, sy, tt, ty = args[:6]
    dom = dict(sig_domain=SIG_DOMAIN, tanh_domain=TANH_DOMAIN)
    codes = torch.full((5, b, h), -1, dtype=torch.int32, device=dev)
    n0 = TLC.lstm_gates_bwd.launches
    got = TLC.lstm_gates_bwd(*args, codes=codes, **dom)
    want = TLC.lstm_gates_bwd_plain(*args, **dom)
    _, c_fwd = TLC.lstm_gates(*args[:6])
    torch.cuda.synchronize()
    assert TLC.lstm_gates_bwd.launches == n0 + 1
    parts = torch.split(gates, h, dim=-1)
    fwd_codes = torch.stack(
        [thermometer_count(x, thr) for x, thr in
         zip(parts + (c_fwd,), (st, tt, st, st, tt))]).to(torch.int32)
    assert torch.equal(codes, fwd_codes)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert int(ulp_distance(g, w).max()) <= BWD_ULPS


NLADC_CASES = [(shape, p, dtype, banked)
               for shape in [(1, 64), (4, 64), (4, 100), (33, 1000),
                             (4, 11008)]
               for p in (8, 16, 32, 7)
               for dtype in (torch.float32, torch.bfloat16)
               for banked in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p,dtype,banked", NLADC_CASES)
def test_nladc_kernel_matches_plain_bitwise(shape, p, dtype, banked):
    """(4, 100) bfloat16: rows of 200 bytes, not 16-byte aligned."""
    dev = _card()
    rng = np.random.default_rng(shape[-1] + p)
    thr = torch.from_numpy(_ramp_thresholds(rng, p, shape[-1], banked))
    x = torch.tensor(rng.normal(0, 2.5, shape), dtype=torch.float32)
    flat = x.view(-1)
    flat[:p] = thr.reshape(-1, p)[0]
    flat[-3:] = torch.tensor([float("nan"), float("inf"), float("-inf")])
    x, thr = x.to(dev, dtype), thr.to(dev)
    y_table = torch.tensor(rng.normal(0, 1, p + 1), dtype=torch.float32,
                           device=dev)
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    n0 = TNK.nladc.launches
    got = TNK.nladc(x, thr, y_table)
    codes = TNK.nladc(x, thr, count)
    torch.cuda.synchronize()
    assert TNK.nladc.launches == n0 + 2
    assert got.dtype == dtype and got.shape == x.shape
    _same_bits(got, TNK.nladc_plain(x, thr, y_table))
    assert torch.equal(codes.float(), thermometer_count(x, thr).float())
    got_u = TNK.nladc(x, _unaligned(thr, dev), _unaligned(y_table, dev))
    torch.cuda.synchronize()
    _same_bits(got_u, got)


@pytest.mark.cuda
def test_launch_floor_writes_its_word():
    dev = _card()
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    n0 = TLF.launch_floor.launches
    TLF.launch_floor(word)
    torch.cuda.synchronize()
    assert int(word.item()) == 1 and TLF.launch_floor.launches == n0 + 1


def _expert_gate_holds_its_contract(x, w, thr, ramp, dev):
    y_table = torch.tensor(ramp.y_table, dtype=torch.float32, device=dev)
    count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32, device=dev)
    n0 = TFM.moe_fused_matmul.launches
    yk = TFM.moe_fused_matmul(x, w, thr, y_table)
    nk = TFM.moe_fused_matmul(x, w, thr, count).long()
    torch.cuda.synchronize()
    assert TFM.moe_fused_matmul.launches == n0 + 2
    assert yk.dtype == x.dtype and torch.equal(yk, y_table[nk].to(x.dtype))
    n_plain = thermometer_count(x.float() @ w, thr)
    acc, bound = TFM.accumulator_bound(x, w)
    flips, unexplained = TFM.code_flips(nk, n_plain, acc, bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * nk.numel()
    # rows that are all zeros give the table at the zero code, bitwise
    zero_rows = (x == 0).all(-1)
    zero = thermometer_count(torch.zeros(w.shape[-1], device=dev), thr)
    assert torch.equal(nk[zero_rows], zero.expand(int(zero_rows.sum()), -1))
    return nk


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n,dtype,tile_cols", [
    (64, 6, 2048, 1408, torch.bfloat16, 0),
    (64, 6, 2048, 1408, torch.bfloat16, 512),
    (5, 7, 300, 1000, torch.float32, 0),
    (3, 9, 64, 80, torch.float32, 16)])
def test_moe_fused_matmul_kernel_matches_plain(e, c, k, n, dtype, tile_cols):
    dev = _card()
    rng = np.random.default_rng(e * 1000 + n)
    ramp = TN.build_ramp("silu", 5)
    thr = _thresholds(rng, ramp, n, tile_cols).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(e * 1000 + n)
    x = torch.randn((e, c, k), generator=gen, device=dev).to(dtype)
    x[0, -1] = 0                                    # an empty capacity row
    w = (2.0 / np.sqrt(k)) * torch.randn((e, k, n), generator=gen,
                                         device=dev)
    _expert_gate_holds_its_contract(x, w, thr, ramp, dev)


def serving_fill(gen, dev, e, k, dtype, tokens=4, top_k=6):
    """The expert buffer of one moonshot decode step: ``tokens`` tokens
    routed to their top-k experts of random scores, gathered by
    ``dispatch_plan`` / ``gather_expert_buffer`` at the model's capacity;
    the capacity rows no token fills are zeros."""
    from repro_torch.nn import moe as M

    xf = torch.randn((tokens, k), generator=gen, device=dev).to(dtype)
    scores = torch.rand((tokens, e), generator=gen, device=dev)
    gates, idx = M.stable_top_k(scores, top_k)
    cap = M.expert_capacity(tokens, top_k, e, 1.0)
    st, _, dest, valid = M.dispatch_plan(idx, gates, tokens, e, cap)
    return M.gather_expert_buffer(xf, st, dest, valid, e, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["all_live", "none_live", "serving",
                                  "one_live_row"])
@pytest.mark.parametrize("tile_cols", [0, 512])
def test_expert_gate_skips_empty_experts(fill, tile_cols):
    dev = _card()
    e, c, k, n = 64, 6, 2048, 1408
    rng = np.random.default_rng(17 + tile_cols)
    ramp = TN.build_ramp("silu", 5)
    thr = _thresholds(rng, ramp, n, tile_cols).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    w = (2.0 / np.sqrt(k)) * torch.randn((e, k, n), generator=gen,
                                         device=dev)
    if fill == "serving":
        x = serving_fill(gen, dev, e, k, torch.bfloat16)
        assert x.shape == (e, c, k)
    else:
        x = torch.randn((e, c, k), generator=gen, device=dev).bfloat16()
        if fill == "none_live":
            x.mul_(0)                               # +0.0 and -0.0
        elif fill == "one_live_row":
            x[:, 1:].mul_(0)
            x[1:4].mul_(0)                          # three empty experts
    live = int((x != 0).any(-1).any(-1).sum())
    assert {"all_live": live == e, "none_live": live == 0,
            "serving": 0 < live <= 24, "one_live_row": live == e - 3}[fill]
    _expert_gate_holds_its_contract(x, w, thr, ramp, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,q_dtype", [
    (4, 128, 16, 16, 128, torch.bfloat16),
    (4, 128, 16, 2, 128, torch.bfloat16),
    (3, 200, 8, 8, 64, torch.float32)])
def test_flash_decode_kernel_matches_plain(b, s, h, hkv, d, q_dtype):
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(s + h)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k8, v8 = (torch.randint(-127, 128, (b, s, hkv, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((1e-3 + 2e-2 * torch.rand((b, s, hkv), generator=gen,
                                        device=dev)).bfloat16()
              for _ in range(2))
    length = torch.tensor([s, 1, 37, 100][:b], dtype=torch.int32,
                          device=dev)
    n0 = TFD.flash_decode_int8.launches
    got = TFD.flash_decode_int8(q, k8, ks, v8, vs, length)
    want = TFD.flash_decode_int8_plain(q, k8, ks, v8, vs, length)
    torch.cuda.synchronize()
    assert TFD.flash_decode_int8.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    assert float((got - want).abs().max()) <= FLASH_ATOL


def _flash_inputs(dev, b, s, h, hkv, d, q_dtype, lengths, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k8, v8 = (torch.randint(-127, 128, (b, s, hkv, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((1e-3 + 2e-2 * torch.rand((b, s, hkv), generator=gen,
                                        device=dev)).bfloat16()
              for _ in range(2))
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k8, ks, v8, vs, length


FLASH_SPLIT_CASES = [  # b, s, h, hkv, d, q dtype, lengths
    (4, 128, 16, 16, 128, torch.bfloat16, [1, 37, 100, 128]),  # serving
    (4, 128, 16, 2, 128, torch.bfloat16, [128, 0, 37, 100]),   # G 8, empty
    (3, 200, 8, 8, 64, torch.float32, [200, 65, 0]),
    (2, 300, 4, 1, 256, torch.float32, [299, 131]),            # G 4, D 256
    (2, 37, 16, 16, 16, torch.bfloat16, [0, 5]),               # D 16
    # granite-34b's group of 48 (6 chunks of 8) and qwen2.5-32b's of 5
    (4, 128, 48, 1, 128, torch.bfloat16, [128, 1, 37, 100]),
    (4, 2048, 48, 1, 128, torch.float32, [2048, 1, 593, 1600]),
    (4, 128, 40, 8, 128, torch.bfloat16, [128, 0, 37, 100]),
    (4, 2048, 40, 8, 128, torch.float32, [2048, 1, 593, 1600]),
    (2, 77, 12, 1, 64, torch.float32, [77, 40])]               # G 12: 6 + 6


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,q_dtype,lengths", FLASH_SPLIT_CASES)
def test_every_split_count_holds_the_flash_contract(b, s, h, hkv, d,
                                                    q_dtype, lengths):
    """Every cluster of 1 to 8 CTAs computes the attention within
    FLASH_ATOL of the plain version (the split count moves the summation
    order, so the bits differ between counts), lengths that are no
    multiple of any tile among them, and a row of length 0 averages V over
    all S slots, as the plain version does."""
    dev = _card()
    args = _flash_inputs(dev, b, s, h, hkv, d, q_dtype, lengths, seed=s + d)
    want = TFD.flash_decode_int8_plain(*args)
    for splits in range(1, 9):
        got = TFD._launch(*args, splits)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (b, h, d)
        assert float((got - want).abs().max()) <= FLASH_ATOL, splits


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,q_dtype,lengths",
                         FLASH_SPLIT_CASES[:2])
def test_flash_decode_reruns_give_the_same_bits(b, s, h, hkv, d, q_dtype,
                                                lengths):
    """Rank 0 combines the splits in split order, with no atomics, and the
    split count is the shape's: two launches on the same inputs agree
    bitwise."""
    dev = _card()
    args = _flash_inputs(dev, b, s, h, hkv, d, q_dtype, lengths, seed=7)
    first = TFD.flash_decode_int8(*args)
    for _ in range(3):
        assert torch.equal(TFD.flash_decode_int8(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d,lengths", [
    (4, 128, 48, 1, 128, [128, 1, 37, 100]),
    (2, 300, 40, 2, 128, [300, 77])])
def test_a_flash_chunk_computes_its_own_bits(b, s, h, hkv, d, lengths,
                                             q_dtype):
    """A group of more than 8 heads runs in chunks of at most 8: every
    chunk gives the bits of a launch over its heads alone, at the same
    split count."""
    dev = _card()
    q, k8, ks, v8, vs, length = _flash_inputs(dev, b, s, h, hkv, d, q_dtype,
                                              lengths, seed=11)
    splits = TFD.split_count(b, hkv, s)
    got = TFD._launch(q, k8, ks, v8, vs, length, splits)
    g = h // hkv
    gc = TFD.chunk_heads(g)
    assert gc <= 8
    qg = q.reshape(b, hkv, g, d)
    for c in range(-(-g // gc)):         # the last chunk may be smaller
        heads = slice(c * gc, min(g, (c + 1) * gc))
        for kv in range(hkv):
            one = [t[:, :, kv:kv + 1].contiguous() for t in (k8, ks, v8, vs)]
            part = TFD._launch(qg[:, kv, heads].contiguous(), *one,
                               length, splits)
            want = got.reshape(b, hkv, g, d)[:, kv, heads]
            assert torch.equal(part, want), (c, kv)


TILE_CASES = [((50, 72, 128), bits, noise, name, dt)
              for bits in (None, 3, 5, 8) for noise in (False, True)
              for name in ("tanh", "swish", "selu")
              for dt in (torch.float32, torch.bfloat16)] + [
    ((1, 33, 7), 4, True, "sigmoid", torch.float32),
    ((2, 3, 40, 24), 5, True, "tanh", torch.bfloat16),
    ((128, 256, 256), None, False, "swish", torch.float32),
    ((16, 632, 8064), 5, True, "tanh", torch.bfloat16),
    ((16, 632, 8064), None, False, "tanh", torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bits,noise,name,dtype", TILE_CASES)
def test_analog_tile_kernel_matches_plain(shape, bits, noise, name, dtype):
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    *lead, k, n = shape
    ramp = TN.build_ramp(name, 5)
    dec = closed_form_params(ramp)
    x = torch.tensor(rng.normal(0, 0.6, (*lead, k)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 2.0 / np.sqrt(k), (k, n)),
                     dtype=torch.float32).to(dev)
    nz = torch.tensor(rng.normal(0, 0.02, (k, n)),
                      dtype=torch.float32).to(dev) if noise else None
    x = x.to(dev, dtype)
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32, device=dev)
    n0 = TAT.analog_tile.launches
    yk = TAT.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits)
    nk = TAT.analog_tile(x, w, thr, ClosedForm(0, 0.0, 1.0, 1.0, 0),
                         w_noise=nz, input_bits=bits).float().long()
    torch.cuda.synchronize()
    assert TAT.analog_tile.launches == n0 + 2
    assert yk.dtype == dtype and yk.shape == (*lead, n)
    assert torch.equal(yk, closed_form_decode_fma(nk.float(), dec).to(dtype))
    xq, w_eff = effective_operands(x.reshape(-1, k), w, nz, bits)
    n_plain = thermometer_count(xq @ w_eff, thr)
    acc, bound = TFM.accumulator_bound(xq, w_eff)
    flips, unexplained = TFM.code_flips(nk.reshape(-1, n), n_plain, acc,
                                        bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * nk.numel()
    plain = TAT.analog_tile_plain(x.reshape(-1, k), w, nz, thr, dec, bits)
    same = nk.reshape(-1, n) == n_plain
    assert torch.equal(yk.reshape(-1, n)[same], plain[same])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bits,noise,name,dtype", TILE_CASES)
def test_every_crossbar_tile_config_computes_the_default_bits(
        shape, bits, noise, name, dtype):
    """Every (rows, cols, ring depth) the kernel takes gives the default
    config's bits: none of them touches the summation order."""
    dev = _card()
    rng = np.random.default_rng(sum(shape) + 1)
    *lead, k, n = shape
    dec = closed_form_params(TN.build_ramp(name, 5))
    thr = torch.tensor(TN.build_ramp(name, 5).thresholds,
                       dtype=torch.float32, device=dev)
    x = torch.tensor(rng.normal(0, 0.6, (*lead, k)),
                     dtype=torch.float32).to(dev, dtype)
    w = torch.tensor(rng.normal(0, 2.0 / np.sqrt(k), (k, n)),
                     dtype=torch.float32).to(dev)
    nz = torch.tensor(rng.normal(0, 0.02, (k, n)),
                      dtype=torch.float32).to(dev) if noise else None
    want = TAT.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits,
                           blocks=TT.default_blocks("analog_tile"))
    for rows in (4, 8, 16):
        for cols in (32, 64):
            for k_tile in (16, 32, 64, 128):
                got = TAT.analog_tile(x, w, thr, dec, w_noise=nz,
                                      input_bits=bits,
                                      blocks=(rows, cols, k_tile))
                assert torch.equal(got, want), (rows, cols, k_tile)


TUNE_CASES = [("fused_matmul_nladc", (4, 2048, 11008), torch.bfloat16, 0),
              ("fused_matmul_nladc", (33, 300, 1000), torch.float32, 0),
              ("fused_matmul_nladc", (6, 2048, 1408), torch.bfloat16, 64),
              ("fused_matmul_nladc", (7, 296, 1000), torch.float32, 5),
              ("analog_tile", (16, 632, 8064), torch.bfloat16, 0),
              ("analog_tile", (50, 72, 128), torch.float32, 0),
              ("nladc", (4, 64), torch.bfloat16, 0),
              ("nladc", (1, 64), torch.bfloat16, 0),
              ("nladc", (4, 11008), torch.bfloat16, 0),
              ("nladc", (33, 1000), torch.float32, 0),
              ("lstm_gates", (16, 2016), torch.float32, 0),
              ("lstm_gates", (33, 100), torch.float32, 0),
              ("lstm_gates", (7, 32), torch.float32, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,dtype,experts", TUNE_CASES)
def test_every_tune_candidate_computes_the_default_bits(kernel, shape,
                                                        dtype, experts):
    dev = _card()
    fn = TT.kernel_fn(kernel, experts)
    args = TT.kernel_inputs(kernel, shape, dtype, dev, seed=3,
                            experts=experts)
    default = TT.default_for(kernel, shape, experts)
    want = TT.as_tuple(fn(*args, blocks=default))
    cands = TT.candidates(kernel, shape, experts)
    assert len(cands) > 1
    for blocks in cands:
        got = TT.as_tuple(fn(*args, blocks=blocks))
        assert all(torch.equal(g, v) for g, v in zip(got, want)), blocks


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,dtype", [
    ("lstm_gates", (16, 2016), torch.float32),
    ("lstm_gates", (7, 40), torch.float32),
    ("nladc", (4, 11008), torch.bfloat16),
    ("nladc", (33, 1000), torch.float32),
    ("nladc", (4, 100), torch.bfloat16)])
def test_every_tune_candidate_computes_the_default_bits_banked(kernel, shape,
                                                               dtype):
    """The elementwise kernels' other kernel: (H, P) or (N, P) thresholds,
    P 31, through every sweep candidate."""
    dev = _card()
    fn = TT.kernel_fn(kernel)
    if kernel == "lstm_gates":
        args = [torch.from_numpy(a).to(dev)
                for a in _lstm_inputs(*shape, 31, True, 5)]
    else:
        rng = np.random.default_rng(5)
        thr = torch.from_numpy(_ramp_thresholds(rng, 31, shape[-1], True))
        x = torch.tensor(rng.normal(0, 2.5, shape), dtype=torch.float32)
        args = [x.to(dev, dtype), thr.to(dev),
                torch.tensor(rng.normal(0, 1, 32), dtype=torch.float32,
                             device=dev)]
    want = TT.as_tuple(fn(*args, blocks=TT.default_blocks(kernel)))
    for blocks in TT.candidates(kernel, shape):
        got = TT.as_tuple(fn(*args, blocks=blocks))
        for g, w in zip(got, want):
            _same_bits(g, w)


@pytest.mark.cuda
def test_cache_miss_launches_the_default_config():
    dev = _card()
    TT._reset_for_tests()
    try:
        for kernel in TT.tunable_kernels():
            shape = (4, 64, 160) if kernel in ("fused_matmul_nladc",
                                               "analog_tile") else (4, 64)
            assert TT.launch_config(kernel, shape, torch.float32, dev) == \
                TT.default_blocks(kernel)
        assert TT.launch_config("fused_matmul_nladc", (6, 64, 160),
                                torch.float32, dev,
                                experts=8) == (8, 128, 64)
        assert TT.launch_config("fused_matmul_nladc", (1024, 2048, 11008),
                                torch.bfloat16, dev) == TT.GEMM_BLOCKS
        assert TT.platform(dev).startswith("sm_")
    finally:
        TT._reset_for_tests()


KERNELS = {"fused_matmul_nladc": TFM.fused_matmul_nladc,
           "prefill_attention": TPA.prefill_attention,
           "nladc": TNK.nladc, "moe_fused_matmul": TFM.moe_fused_matmul,
           "flash_decode_int8": TFD.flash_decode_int8}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv,path", [
    ("qwen2.5-3b", "bfloat16", ("fused_matmul_nladc", "prefill_attention")),
    ("moonshot-v1-16b-a3b", "int8",
     ("fused_matmul_nladc", "nladc", "moe_fused_matmul",
      "flash_decode_int8")),
    ("whisper-base", "bfloat16", ("fused_matmul_nladc",
                                  "prefill_attention"))])
def test_smoke_lm_cuda_backend_matches_ref(arch, kv, path):
    dev = _card()
    models = {}
    for bk in ("cuda", "ref"):
        cfg = configs.get_smoke(arch)
        cfg = cfg.replace(dtype="float32", kv_cache_dtype=kv,
                          analog=dataclasses.replace(cfg.analog, backend=bk))
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = models["cuda"].init(gen)
    tokens = torch.randint(0, cfg.vocab, (8, 2, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(2, 16) for bk, m in models.items()}
    n0 = {name: fn.launches for name, fn in KERNELS.items()}
    worst = 0.0
    for t in range(tokens.shape[0]):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(params, states[bk],
                                                   tokens[t])
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    layers = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
    assert {name: fn.launches - n0[name] for name, fn in KERNELS.items()} \
        == {name: layers * 8 if name in path else 0 for name in KERNELS}
    assert worst < models["cuda"].act.ramp.lsb / 2


FN_TOL = 1e-5


def _grads(fn, args, ct):
    targs = [a.detach().clone().requires_grad_(True) for a in args]
    y = fn(*targs)
    return y, torch.autograd.grad(y, targs, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["nladc", "gate", "gate_bias", "expert_gate",
                                  "attention"])
def test_cuda_functions_carry_the_reference_gradient(what):
    from repro_torch.core.backend import get_backend

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(what))

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    adc = TN.NLADC(TN.build_ramp("sigmoid" if what == "nladc" else "silu",
                                 5), dev)
    if what == "nladc":
        args, kernel = [rn(24, 64, scale=4.0)], TNK.nladc
        call = lambda bk, x: bk.nladc(x, adc)
    elif what.startswith("gate"):
        bias = rn(160, scale=0.5) if what == "gate_bias" else None
        args, kernel = [rn(3, 5, 64), rn(64, 160, scale=0.3)], \
            TFM.fused_matmul_nladc
        call = lambda bk, x, w: bk.matmul_nladc(x, w, adc, bias=bias)
    elif what == "expert_gate":
        x = rn(4, 6, 64)
        x[1, -2:] = 0.0
        args, kernel = [x, rn(4, 64, 32, scale=0.3)], TFM.moe_fused_matmul
        call = lambda bk, a, w: bk.moe_matmul_nladc(a, w, adc)
    else:
        mask = (torch.arange(10, device=dev)[None, None, :]
                < torch.tensor([10, 1, 6], device=dev)[:, None, None])
        args, kernel = [rn(3, 1, 4, 16), rn(3, 10, 2, 16),
                        rn(3, 10, 2, 16)], TPA.prefill_attention
        call = lambda bk, q, k, v: bk.prefill_attention(q, k, v, mask)
    cuda, ref = get_backend("cuda"), get_backend("ref")
    with torch.no_grad():
        n0 = kernel.launches
        assert call(cuda, *args).grad_fn is None
        assert kernel.launches == n0 + 1
    y_ref = call(ref, *args)
    ct = rn(*y_ref.shape)
    n0 = kernel.launches
    y, got = _grads(lambda *a: call(cuda, *a), args, ct)
    assert y.grad_fn is not None and kernel.launches == n0 + 1
    _, want = _grads(lambda *a: call(ref, *a), args, ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=FN_TOL, atol=FN_TOL)
        assert float(g.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b"])
def test_smoke_lm_train_grads_cuda_match_ref(arch):
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.train import optim

    dev = _card()
    models, grads, losses, launched = {}, {}, {}, {}
    for bk in ("cuda", "ref"):
        cfg = configs.get_smoke(arch)
        cfg = cfg.replace(dtype="float32", analog=dataclasses.replace(
            cfg.analog, backend=bk, mode="train", device="paper"))
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = models["cuda"].init(gen)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    for bk, m in models.items():
        ng = torch.Generator(device=dev)
        ng.manual_seed(1)
        n0 = {name: fn.launches for name, fn in KERNELS.items()}
        total, _ = m.loss(params, batch, noise=GeneratorNoise(ng),
                          remat=True)
        grads[bk] = torch.autograd.grad(total, leaves)
        losses[bk] = total.detach()
        launched[bk] = {name: fn.launches - n0[name]
                        for name, fn in KERNELS.items()}
    path = ("fused_matmul_nladc",) if arch == "qwen2.5-3b" else \
        ("fused_matmul_nladc", "nladc", "moe_fused_matmul")
    assert launched == {
        "cuda": {name: 2 * cfg.n_layers if name in path else 0
                 for name in KERNELS},
        "ref": {name: 0 for name in KERNELS}}
    torch.testing.assert_close(losses["cuda"], losses["ref"], rtol=2e-4,
                               atol=2e-5)
    for g, w in zip(grads["cuda"], grads["ref"]):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [
    ("qwen2.5-3b", {}), ("moonshot-v1-16b-a3b", {}),
    ("recurrentgemma-9b", {"n_layers": 5})])
def test_remat_policies_compute_the_same_bits(arch, overrides):
    """Train mode on the ``cuda`` backend (recurrentgemma with one group
    and its tail): the loss and every gradient leaf bitwise equal under
    ``remat_policy`` "full", "dots" and "none"; the gate kernels launch
    twice per recomputed block under "full" and "dots" (the selective
    checkpoint recomputes a ``ctypes`` launch: it is no matrix product),
    once under "none"."""
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.train import optim

    dev = _card()
    base = configs.get_smoke(arch).replace(dtype="float32", **overrides)
    base = base.replace(analog=dataclasses.replace(
        base.analog, backend="cuda", mode="train", device="paper"))
    model = build(base, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, base.vocab, (2, 16), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    got = {}
    for policy in ("full", "dots", "none"):
        model.cfg = base.replace(remat_policy=policy)
        ng = torch.Generator(device=dev)
        ng.manual_seed(1)
        n0 = {name: fn.launches for name, fn in KERNELS.items()}
        total, _ = model.loss(params, batch, noise=GeneratorNoise(ng),
                              remat=True)
        got[policy] = (total.detach(), torch.autograd.grad(total, leaves),
                       {name: fn.launches - n0[name]
                        for name, fn in KERNELS.items()})
    for policy in ("dots", "none"):
        assert torch.equal(got[policy][0], got["full"][0]), policy
        for g, w in zip(got[policy][1], got["full"][1]):
            assert torch.equal(g, w), policy
    for name, n in got["none"][2].items():
        assert got["full"][2][name] == got["dots"][2][name] >= n, name
    assert got["full"][2]["fused_matmul_nladc"] \
        > got["none"][2]["fused_matmul_nladc"] > 0
