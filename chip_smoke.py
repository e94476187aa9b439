#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the build of the seven kernel sources from
              ``kernels/csrc`` (the six ports and the launch floor; one
              nvcc each, started together).
2. kernel   — the ``lstm_gates`` kernel against its plain torch version and
              the ``ref`` backend on the card, at (B=16, H=2016) with one
              (P,) ramp, at (16, 2016) with (H, P) threshold banks (4 banks
              of 512 columns), and at (7, 32) for the ragged edge.  Bitwise:
              max abs diff 0 and 0 code mismatches.  Time per call through
              the wrapper (CUDA events) beside the kernel's bound.
3. ptb      — ptb_lstm at its published widths (128 -> LSTM 2016, proj 504
              -> 50), infer mode on the ``paper-infer`` device model, 2 eval
              batches of B 16 x T 128, with ``bank_cols`` 0 and 512, on the
              ``cuda`` backend.  The kernel must launch batches x T times;
              logits must match the ``ref`` backend on the card (same
              weights, same read-noise generator state).
4. kws      — kws_lstm at full width (40 -> 32 -> 12, T 49), same checks.
4a. kernel_bwd — the ``lstm_gates_bwd`` kernel (the tail's straight-through
              backward, Alg. 1) against its plain torch version on
              train-noise thresholds at PTB (16, 2016) with one (P,) ramp
              and with 512-column banks, KWS (64, 32) and a ragged (7, 32):
              its five rematerialized codes equal the forward kernel's (0
              mismatches), its gradients within BWD_ULPS float32 ulps;
              max abs and ulp errors, time per call beside the bound.
4b. train_ptb — Alg. 1 training of ptb_lstm at its published widths
              (B 16, T 128) on the ``paper`` device model (train noise on
              the weights and the ramp steps), bank_cols 0 and 512, on the
              ``cuda`` backend (``repro_torch.launch.lstm_train``): the
              first step's gradients on ``cuda`` and on ``ref`` (same
              weights, the same generator state replayed) within rtol
              2e-4 / atol 2e-5; then 4 Adam steps, each launching the
              forward and the backward tail kernels T times, every loss
              finite; then the trained weights evaluated in infer mode.
              Median ms per train step with its spread, peak memory.
4c. train_kws — the same for kws_lstm (B 64, T 49, fig4d's batch).
4d. ir      — the IR-drop correction (``core/crossbar.py::
              ir_effective_weights_tiled``, plain torch: the reference's
              is plain jnp) on the card at PTB's ``w_gates`` (632, 8064:
              16 col tiles of two shapes) and ``w_proj`` (2016, 504: 4 row
              tiles of two shapes), on ``paper-ir`` (1 ohm, single) and
              ``stressed-ir`` (2.5 ohm, double): within IR_ULPS float32
              ulps of the same function in float64 on the host (ulps at the
              float64 value); ms per call (CUDA events) beside the byte
              bound; launches and device ms per call under ``kernel_time``.
4e. ptb_ir  — ptb_lstm as in ``ptb`` on ``paper-ir`` and ``stressed-ir``,
              bank_cols 0 and 512, the weights aged per crossbar tile
              (``lstm_eval --age-weights tiled``): ``lstm_gates`` launches
              batches x T times, ``cuda`` and ``ref`` logits within
              LOGIT_ATOL; bits per character beside ``paper-infer``'s, ms
              per step (median, spread), peak memory.
4f. kws_ir  — the same for kws_lstm (accuracy beside ``paper-infer``'s).
4g. train_kws_ir — ``train_kws`` on ``paper-ir``: the IR correction and
              the I-V transform in the graph; first-step gradients on
              ``cuda`` and ``ref`` within rtol 2e-4 / atol 2e-5, both tail
              kernels T launches a step.
4h. fig4d   — ``benchmarks/fig4d_kws.py``'s quick mode on the card
              (``lstm_train.fig4d``): 768 training samples, 4 epochs, float
              vs 5-, 4- and 3-bit NL-ADCs trained with Alg. 1 noise, read
              noise at evaluation over 3 chip seeds; the four accuracies
              and whether float >= 5b >= 4b >= 3b held (printed, not
              gated, as the benchmark prints it).
5. fused_matmul — the ``fused_matmul_nladc`` kernel against its plain
              version at the serving path's shapes (4 and 1 rows, K 2048,
              N 11008, bfloat16 x, float32 w: the GEMV, M <= 8) with one
              (P,) ramp and with 512-column threshold banks, a ragged
              float32 case (M 33: the tensor-core GEMM, x split in three
              bfloat16 parts), and the training shape (M = B x S = 1024,
              flat and banked-512: the GEMM).  Codes equal except where the
              float64 accumulator lies within the float32 summation bound
              of a crossed threshold (the count of such flips is printed);
              outputs equal the table at the kernel's codes.  Each case's
              bound is its route's (``matmul_bound``), the float32
              CUDA-core bound beside it.
6. attention — the ``prefill_attention`` kernel (one thread-block cluster
              per KV head and batch row) against its plain version at
              (B 4, H 16, Hkv 2, D 128, S 128), bfloat16 and float32, and
              at S 2048 in bfloat16, ragged masks (one row sees a single
              slot): max abs diff 1e-6 in float32, one bfloat16 ulp; the
              cluster size of each case.
7. serve    — qwen2.5-3b at full width and all 36 layers, bfloat16
              compute, ``cuda`` backend, seeded weights: 4 requests,
              max_batch 4, max_len 128, max_new 16.  Every request gets its
              16 tokens, every step's logits are finite, and each kernel
              launches 36 x (prefill steps + decode steps) times.  Tokens/s
              and ms per decode step: median of repeated runs, with spread.
8. agreement — a 2-layer, full-width, float32 variant decoded on the
              ``cuda`` and ``ref`` backends on the card: max |delta logits|
              < LSB/2 of the silu ramp.
9. nladc    — the elementwise ``nladc`` kernel against its plain version
              at the router's (4, 64) bfloat16 with one (P,) ramp (and
              (1024, 64), the router at the training shape), at
              (4, 11008) bfloat16 with 512-column banks, and a ragged
              float32 (33, 1000): codes bitwise, values equal.
10. moe_matmul — the ``moe_fused_matmul`` kernel (persistent CTAs, a TMA
              weight stream that skips empty experts) against its plain
              version at the expert gate's shape (64 experts, C 6, d 2048,
              f 1408, bfloat16 x, float32 w), every expert live, flat and
              banked-512; the serving fill (x from ``dispatch_plan`` /
              ``gather_expert_buffer`` at B 4, top-6: the live experts
              counted, the bound counting only their weight); no expert
              live; a ragged float32 (5, 7, 300, 1000); and the training
              fill (C 96 = 1024 tokens x top-6 / 64, every expert live):
              the fused
              matmul's flip contract (at most 1%), outputs equal to the
              table at the kernel's codes, empty capacity rows the table at
              the zero code.
11. flash_decode — the int8 ``flash_decode_int8`` kernel (a cluster of
              CTAs splitting each KV head's slots) against its plain
              version at the serving shape (B 4, H = Hkv = 16, D 128,
              S 128) with full rows and with growing lengths (1, 37, 100,
              128), a GQA case (H 16, Hkv 2), a row of length 0 (V averaged
              over all slots), and ragged S and lengths: max abs diff 1e-5;
              the split count of each case.
12. serve_moe — moonshot-v1-16b-a3b at full width, 24 of its 48 layers
              (f32 weights, 59.1 GB, drawn on the card), int8 KV cache,
              bfloat16 compute, ``cuda`` backend: 4 requests, max_batch 4,
              max_len 128, max_new 16.  ``nladc``, ``moe_fused_matmul``,
              ``flash_decode_int8`` and ``fused_matmul_nladc`` (the shared
              experts) each launch 24 x (prefill steps + decode steps)
              times, ``prefill_attention`` never; every step's logits are
              finite; peak device memory.
13. agreement_moe — a 2-layer, full-width, float32 moonshot with an int8
              cache on the ``cuda`` and ``ref`` backends: max |delta
              logits| < LSB/2.
13a. train_lm — qwen2.5-3b trained at full width and all 36 layers
              (``repro_torch.launch.train``: B 8 x S 128, train mode on the
              ``paper`` preset, flat thresholds, AdamW with clip 1.0, each
              layer recomputed in the backward), ``cuda`` backend, 3 steps,
              then ``train_lm_banked`` the same with 512-column banks:
              every loss and gradient norm finite, ``fused_matmul_nladc``
              36 x 2 launches a step and no other kernel; ms per step
              (steps 2-3), tokens/s, peak device memory (< 80 GB).
13b. train_moe — moonshot-v1-16b-a3b at full width, 4 of its 48 layers,
              the same: ``nladc`` (the router), ``moe_fused_matmul`` (the
              routed experts' gate) and ``fused_matmul_nladc`` (the shared
              experts' gate) each 4 x 2 a step; the aux losses.
13c. train_agreement — both families at full width, 2 layers, float32,
              B 2 x S 32, train mode, seed 4 (``--agreement-seeds`` runs
              other seeds alone; the M 64 gate is the tensor-core GEMM
              with float32 x split in three): ``cuda`` against ``ref`` on
              the same weights and ramp draws; every NL-ADC call's outputs
              compared, on the same inputs and in free runs: those that
              differ (code flips) at most 1e-4 of them, each one level
              of the decode table apart; the loss within rtol 2e-4 /
              atol 2e-5; every gradient leaf within rtol 2e-4 / atol
              2e-5 of ``ref`` given the cuda run's gate outputs, and of
              ``ref`` itself where no code flipped, within that plus
              2e-3 where codes flipped (a flip moves the gradients
              downstream of it).
13d. lm_infer — ``serve`` in infer mode on ``paper-infer`` (the ramps
              programmed once at build time; ``paper`` has no build stage,
              so infer mode on it is exact mode), 4 requests x 16 tokens;
              then ``lm_infer_agreement``, ``agreement`` in infer mode.
14. analog_tile — the crossbar-tile kernel against its plain version at
              the PTB gate crossbar as one tile (16, 632, 8064; bfloat16 x,
              5-bit PWM, read noise, tanh), the JAX sweep's (128, 256, 256)
              (float32, no noise or PWM, swish) and a ragged float32
              (33, 300, 1000) with 3-bit PWM, noise and selu: the fused
              matmul's flip contract on the effective operands (at most
              1%), outputs equal to the closed-form decode at the kernel's
              codes.
15. kernel_tune — the kernel-autotune entry point
              (``repro_torch.launch.kernel_tune --full``) on the card: every
              candidate config of the four tunable kernels computes the
              default config's bits, the chosen configs and times per
              shape, the parity section with its gradient halves (the
              expert gate's and the cached attention's backward against
              ``ref``, within 1e-5); each kernel of that path launches;
              then host µs per ``fused_matmul_nladc`` call at M 4 with the
              sweep's cache active against none.
16. launch_floor — the device time of one launch of a kernel of one
              block that writes one word (``kernels/launch_floor.py``),
              by the profiler: what any launch costs on this card, beside
              which the tiny cases are read.  No bound.
    kernel_time — device time per call of each kernel, of its plain
              version and of the PyTorch call used as a yardstick
              (torch.profiler; CUDA events where three profiler sessions
              in a row record no device time, or where a reading falls
              under the launch floor or, for a kernel and its plain
              version, under the case's bound), after the main paths; the
              same clock for the IR correction (``ir_time``: kernels
              launched per call, device ms).
17. kernels — one line listing every ported kernel with its launches on
              the main paths (``lstm_gates_bwd``: on the train paths), its
              error against the plain version and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises.  ``python3 chip_smoke.py --agreement-seeds 4 5 6`` runs only
``train_agreement``, for both families at each seed, and prints no
``ok`` line.  Without a GPU, or without the repository's ``src/repro_torch``
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores

H100_BF16_OPS_PER_S = 989e12   # bfloat16 tensor cores, dense

PTB_BATCHES, PTB_BATCH, PTB_SEQ = 2, 16, 128
KWS_BATCHES, KWS_BATCH = 2, 16
TIMING_REPEATS = 4
LOGIT_ATOL = 1e-6   # cuda vs ref backend: the tails are bitwise equal, so
#                     any code flip would show as an LSB-sized jump
KERNELS = ("lstm_cell", "fused_matmul_nladc", "prefill_attention", "nladc",
           "flash_decode_int8", "analog_tile", "launch_floor",
           "lstm_cell_bwd")
BWD_ULPS = 4        # lstm_gates_bwd vs plain: expf / tanhf against torch's
#                     sigmoid / tanh, through a chain of two products
TRAIN_STEPS = 4
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5     # cuda vs ref first-step gradients
KWS_TRAIN_BATCH = 64
IR_PRESETS = ("paper-ir", "stressed-ir")
IR_SHAPES = (("w_gates", (632, 8064)), ("w_proj", (2016, 504)))
IR_ULPS = 32        # IR correction vs float64, ulps at the float64 value
MAX_FLIP_SHARE = 0.01      # fused matmul: explained code flips, at most
ATTN_F32_ATOL = 1e-6
SERVE = dict(arch="qwen2.5-3b", requests=4, max_batch=4, max_len=128,
             max_new=16, repeats=5)
AGREE_LAYERS, AGREE_STEPS = 2, 8
SERVE_MOE = dict(arch="moonshot-v1-16b-a3b", n_layers=24,
                 kv_cache_dtype="int8", requests=4, max_batch=4, max_len=128,
                 max_new=16, repeats=3)
FLASH_ATOL = 1e-5
HOST_CALLS, HOST_REPEATS = 200, 5
GRAD_HALF_ATOL = 1e-5      # kernel_tune's gradient halves, cuda vs ref
TRAIN_LM = dict(arch="qwen2.5-3b", batch=8, seq=128, steps=3,
                analog_device="paper")
TRAIN_MOE = dict(arch="moonshot-v1-16b-a3b", n_layers=4, batch=8, seq=128,
                 steps=3, analog_device="paper")
TRAIN_AGREE = dict(n_layers=2, batch=2, seq=32, seed=4)
AGREE_FLIP_SHARE = 1e-4    # train_agreement: gate outputs that differ
#                            between the backends, at most (qwen2.5-3b
#                            showed 80 of 1409024 = 5.7e-5 on an H100)
AGREE_FLIP_GRAD_EXCESS = 2e-3   # gradient excess over TRAIN_RTOL /
#                            TRAIN_ATOL against ``ref`` itself where codes
#                            flipped (qwen2.5-3b showed 1.016e-3 on an H100)
LM_INFER_DEVICE = "paper-infer"   # `paper` has no build stage: infer = exact
CARD_GB = 80.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, *, reps: int = 20, inner: int = 50) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls (ms)."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, *, calls: int = 50,
              floor_ms: float = 0.0) -> tuple[float, str]:
    """Device time per call (ms) and the clock that gave it: the summed
    device time of every kernel ``fn`` launched under ``torch.profiler``
    (host time between launches is not counted), or CUDA events around
    back-to-back calls where three profiler sessions recorded no device
    event or the profiler read less than ``floor_ms`` (the launch floor or
    the call's bound, which no reading can beat)
    (``repro_torch.kernels.tune.device_us``, which also makes up for the
    events a session loses)."""
    from repro_torch.kernels.tune import device_us

    us, clock = device_us(fn, calls=calls, floor_us=floor_ms * 1e3)
    check(us > 0, "neither the profiler nor CUDA events timed the call")
    return us / 1e3, clock


def tail_bound(b: int, h: int, p: int, banked: bool) -> dict:
    """The least time the card needs for one lstm_gates call: every input
    read once and every output written once at the HBM rate, against the
    5 NL-ADCs' compares (P each) plus i*a, the FMA (2) and o*t over the
    float32 rate."""
    thr = 2 * (h * p if banked else p)
    n_bytes = 4 * (b * 4 * h + b * h + thr + 2 * (p + 1) + 2 * b * h)
    n_ops = b * h * (5 * p + 4)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel(torch, dev, name: str, b: int, h: int, bank_cols: int):
    """The kernel against the plain version and the ref backend."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, mode="infer",
                       device="paper-infer", bank_cols=bank_cols)
    sig = AnalogActivation("sigmoid", cfg, dev)
    tnh = AnalogActivation("tanh", cfg, dev)
    s_thr, t_thr = sig.thresholds_for(h), tnh.thresholds_for(h)
    banked = not isinstance(s_thr, torch.Tensor)
    st = s_thr.per_column if banked else s_thr
    tt = t_thr.per_column if banked else t_thr
    p = st.shape[-1]

    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 10_000 + h)
    gates = 2.0 * torch.randn((b, 4 * h), generator=gen, device=dev)
    c = 1.5 * torch.randn((b, h), generator=gen, device=dev)
    # inputs exactly on thresholds exercise the strict comparator
    cols = torch.arange(h, device=dev)
    k = cols % p
    gates[0, cols] = st[cols, k] if banked else st[k]
    gates[0, h + cols] = tt[cols, k] if banked else tt[k]
    c[0] = 0.0

    args = (gates, c, st, sig.adc.y_table, tt, tnh.adc.y_table)
    hk, ck = lstm_cell.lstm_gates(*args)
    hp, cp = lstm_cell.lstm_gates_plain(*args)
    hr, cr = get_backend("ref").lstm_gates(gates, c, sig.adc, tnh.adc,
                                           sig_thr=s_thr, tanh_thr=t_thr)
    torch.cuda.synchronize()
    diff = max(float((hk - hp).abs().max()), float((ck - cp).abs().max()))
    diff_ref = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
    code_mismatch = int((thermometer_count(ck, tt)
                         != thermometer_count(cp, tt)).sum()) + \
        int((hk != hp).sum()) + int((ck != cp).sum())
    check(torch.equal(hk, hp) and torch.equal(ck, cp),
          f"{name}: kernel differs from its plain version (max {diff})")
    check(torch.equal(hk, hr) and torch.equal(ck, cr),
          f"{name}: kernel differs from the ref backend (max {diff_ref})")
    check(bool(torch.isfinite(hk).all() and torch.isfinite(ck).all()),
          f"{name}: non-finite outputs")

    def kernel():
        return lstm_cell.lstm_gates(*args)

    def plain():
        return lstm_cell.lstm_gates_plain(*args)

    out = {"phase": "kernel", "case": name, "B": b, "H": h, "P": p,
           "layout": "(H,P)" if banked else "(P,)", "max_abs_err": diff,
           "max_abs_err_vs_ref_backend": diff_ref,
           "code_mismatches": code_mismatch,
           # time per call through the wrapper: CUDA events around
           # back-to-back calls, so host time between launches counts
           "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain, inner=5),
           **tail_bound(b, h, p, banked)}
    emit(out)
    return out, kernel, plain


def bwd_bound(b: int, h: int, p: int, banked: bool) -> dict:
    """The least time the card needs for one lstm_gates_bwd call: gates, c,
    both cotangents, the thresholds and tables read once, d_gates and d_c
    written once, against the 5 NL-ADCs' compares (P each) and the chain's
    arithmetic (i*a, the FMA, 5 g' of about 5 operations each, 11 products
    and the add: 39) over the float32 rate."""
    thr = 2 * (h * p if banked else p)
    n_bytes = 4 * (b * 4 * h + 3 * b * h + thr + 2 * (p + 1)
                   + b * 4 * h + b * h)
    n_ops = b * h * (5 * p + 39)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel_bwd(torch, dev, name: str, b: int, h: int, bank_cols: int):
    """The backward kernel against its plain version on train-noise
    thresholds: codes equal the forward kernel's, gradients within
    BWD_ULPS."""
    from repro_torch.core import functions as F
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import thermometer_count, ulp_distance

    cfg = AnalogConfig(enabled=True, adc_bits=5, mode="train",
                       device="paper", bank_cols=bank_cols)
    sig = AnalogActivation("sigmoid", cfg, dev)
    tnh = AnalogActivation("tanh", cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 10_000 + h)
    z = sig.ramp_noise(GeneratorNoise(gen), h)
    s_thr, t_thr = sig.thresholds_for(h, z=z), tnh.thresholds_for(h, z=z)
    banked = not isinstance(s_thr, torch.Tensor)
    st = s_thr.per_column if banked else s_thr
    tt = t_thr.per_column if banked else t_thr
    p = st.shape[-1]

    gates = 2.0 * torch.randn((b, 4 * h), generator=gen, device=dev)
    c = 1.5 * torch.randn((b, h), generator=gen, device=dev)
    ct_h = torch.randn((b, h), generator=gen, device=dev)
    ct_c = torch.randn((b, h), generator=gen, device=dev)
    # inputs on thresholds and on the domain edges
    cols = torch.arange(h, device=dev)
    k = cols % p
    gates[0, cols] = st[cols, k] if banked else st[k]
    gates[0, h + cols] = tt[cols, k] if banked else tt[k]
    dom = dict(sig_domain=(F.SIGMOID.x_lo, F.SIGMOID.x_hi),
               tanh_domain=(F.TANH.x_lo, F.TANH.x_hi))
    if b > 1:
        gates[1, :h] = dom["sig_domain"][0]
        gates[1, h:2 * h] = dom["tanh_domain"][1]

    args = (gates, c, st, sig.adc.y_table, tt, tnh.adc.y_table, ct_h, ct_c)
    codes = torch.full((5, b, h), -1, dtype=torch.int32, device=dev)
    dg, dc = lstm_cell.lstm_gates_bwd(*args, codes=codes, **dom)
    pg, pc = lstm_cell.lstm_gates_bwd_plain(*args, **dom)
    _, c_fwd = lstm_cell.lstm_gates(*args[:6])
    torch.cuda.synchronize()
    parts = torch.split(gates, h, dim=-1) + (c_fwd,)
    fwd_codes = torch.stack([thermometer_count(x, thr) for x, thr in zip(
        parts, (st, tt, st, st, tt))]).to(torch.int32)
    code_mismatch = int((codes != fwd_codes).sum())
    ulps = max(int(ulp_distance(dg, pg).max()), int(ulp_distance(dc,
                                                                  pc).max()))
    diff = max(float((dg - pg).abs().max()), float((dc - pc).abs().max()))
    check(code_mismatch == 0,
          f"{name}: {code_mismatch} rematerialized codes differ from the "
          f"forward kernel's")
    check(ulps <= BWD_ULPS, f"{name}: gradients {ulps} ulps from the plain "
          f"version (bound {BWD_ULPS})")
    check(bool(torch.isfinite(dg).all() and torch.isfinite(dc).all()),
          f"{name}: non-finite gradients")

    def kernel():
        return lstm_cell.lstm_gates_bwd(*args, **dom)

    def plain():
        return lstm_cell.lstm_gates_bwd_plain(*args, **dom)

    out = {"phase": "kernel_bwd", "case": name, "B": b, "H": h, "P": p,
           "layout": "(H,P)" if banked else "(P,)", "max_abs_err": diff,
           "max_ulps": ulps, "ulp_bound": BWD_ULPS,
           "code_mismatches": code_mismatch,
           "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain, inner=5),
           **bwd_bound(b, h, p, banked)}
    emit(out)
    return out, kernel, plain


def phase_train(torch, dev, config: str, bank_cols: int,
                analog_device: str = "paper") -> dict:
    """Alg. 1 training at full width on the cuda backend: first-step
    gradients against the ref backend, TRAIN_STEPS Adam steps with the
    tail kernels' launches counted, then an infer-mode evaluation."""
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import lstm_train
    from repro_torch.train import optim

    all_steps = config == "ptb_lstm"
    batch = PTB_BATCH if all_steps else KWS_TRAIN_BATCH
    lr = lstm_train.DEFAULTS[config][2]
    analog = lstm_train.analog_config("train", analog_device=analog_device,
                                      bank_cols=bank_cols, backend="cuda")
    model = lstm_train.build_model(config, analog, dev, seed=0)
    ref = lstm_train.build_model(
        config, analog.replace(backend="ref"), dev,
        params=optim.tree_map(lambda t: t.detach().clone(), model.params()))
    batches = lstm_train.ptb_train_batches(batch, PTB_SEQ, dev) \
        if all_steps else lstm_train.kws_train_batches(batch, dev)
    xs, labels = next(batches)
    t_steps = xs.shape[1]

    # the first step's gradients on both backends, the same draws
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = gen.get_state()
    loss_c, grad_c = lstm_train.loss_and_grads(
        model, xs, labels, noise=GeneratorNoise(gen), all_steps=all_steps)
    gen.set_state(state)
    loss_r, grad_r = lstm_train.loss_and_grads(
        ref, xs, labels, noise=GeneratorNoise(gen), all_steps=all_steps)
    grad_diff, grad_max, grad_ok = {}, {}, True
    for gc, gr, name in zip(optim.tree_leaves(grad_c),
                            optim.tree_leaves(grad_r),
                            ("fc/w", "lstm/w_gates", "lstm/w_proj")):
        grad_diff[name] = float((gc - gr).abs().max())
        grad_max[name] = float(gc.abs().max())
        grad_ok &= bool(torch.allclose(gc, gr, rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL))
    check(grad_ok, f"{config}/{analog_device}/bank_cols={bank_cols}: cuda "
          f"and ref first-step "
          f"gradients differ beyond rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}: "
          f"{grad_diff}")
    del ref

    torch.cuda.reset_peak_memory_stats(dev)
    lstm_cell.lstm_gates.launches = 0
    lstm_cell.lstm_gates_bwd.launches = 0
    res = lstm_train.train(model, batches, TRAIN_STEPS, lr=lr, seed=0,
                           all_steps=all_steps)
    fwd, bwd = lstm_cell.lstm_gates.launches, lstm_cell.lstm_gates_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(res["fwd_launches"] == [t_steps] * TRAIN_STEPS
          and res["bwd_launches"] == [t_steps] * TRAIN_STEPS,
          f"{config}/bank_cols={bank_cols}: per-step launches fwd "
          f"{res['fwd_launches']} bwd {res['bwd_launches']}, expected "
          f"{t_steps} each")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"{config}: non-finite losses {res['losses']}")
    ev = lstm_train.evaluate_trained(
        model, config, eval_batches=1, batch=PTB_BATCH if all_steps
        else KWS_BATCH, seq=PTB_SEQ, seed=3)
    check(math.isfinite(ev["nll"]), f"{config}: non-finite eval NLL")
    suffix = "" if analog_device == "paper" else "_ir"
    out = {"phase": "train_" + config.split("_")[0] + suffix,
           "config": config, "bank_cols": bank_cols,
           "analog_device": analog_device, "B": batch,
           "T": t_steps, "steps": TRAIN_STEPS, "losses": res["losses"],
           "grad_norms": res["grad_norms"], "first_loss_cuda": float(loss_c), "first_loss_ref": float(loss_r),
           "grad_max_abs": grad_max,
           "grad_max_abs_diff_vs_ref": grad_diff, "grad_rtol": TRAIN_RTOL,
           "grad_atol": TRAIN_ATOL, "launches_fwd": fwd, "launches_bwd": bwd,
           "expected_launches_each": TRAIN_STEPS * t_steps,
           "step_ms": statistics.median(res["step_ms"]),
           "step_ms_min": min(res["step_ms"]),
           "step_ms_max": max(res["step_ms"]), "peak_memory_gb": peak_gb,
           "eval_infer": ev}
    emit(out)
    return out


def phase_fig4d(torch, dev) -> dict:
    """fig4d's quick mode on the card: printed, not gated."""
    from repro_torch.launch import lstm_train

    t0 = time.perf_counter()
    res = lstm_train.fig4d(dev, backend="cuda", quick=True, n_chips=3)
    out = {"phase": "fig4d", "n_train": res["n_train"],
           "epochs": res["epochs"],
           "accuracy": {k: v["accuracy"] for k, v in res["rows"].items()},
           "spread": {k: v["spread"] for k, v in res["rows"].items()},
           "ordering_float_5b_4b_3b_held": res["ordering_held"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def phase_kernel_time(case: dict, kernel, plain, library=None,
                      floor_ms: float = 0.0) -> dict:
    """Device time per call (torch.profiler) of a kernel, its plain version
    and, where there is one, the PyTorch call used as a yardstick.  Run
    after the main paths: once the profiler has attached in a process,
    host launches there are slower, which would skew the step times.  A
    reading under the launch floor ``floor_ms``, or for the kernel and its
    plain version under the case's bound, is taken again by CUDA events."""
    least = max(floor_ms, case["bound_ms"])
    ms, ms_by = device_ms(kernel, floor_ms=least)
    plain_ms, plain_by = device_ms(plain, calls=10, floor_ms=least)
    library_ms, library_by = device_ms(library, floor_ms=floor_ms) \
        if library else (None, None)
    timed_by = {"ms": ms_by, "plain_ms": plain_by, "library_ms": library_by}
    out = {"phase": "kernel_time", "case": case["case"], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
           "timed_by": timed_by}
    emit(out)
    case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                timed_by=timed_by)
    return case


def phase_launch_floor(torch, dev, module) -> dict:
    """Device time of one launch of the one-block kernel that writes one
    word, on ``kernel_time``'s clock: the floor of every launch."""
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    n0 = module.launch_floor.launches
    module.launch_floor(word)
    torch.cuda.synchronize()
    check(int(word.item()) == 1 and module.launch_floor.launches == n0 + 1,
          "launch_floor: the kernel did not write its word")
    ms, clock = device_ms(lambda: module.launch_floor(word))
    out = {"phase": "launch_floor", "us": ms * 1e3, "timed_by": clock}
    emit(out)
    return out


def phase_model(torch, dev, config: str, bank_cols: int, n_batches: int,
                batch: int, seq: int = 0, *,
                analog_device: str = "paper-infer", age_weights: str = "none",
                baseline: dict = None):
    """One main-path run on the cuda backend, checked against ref;
    ``baseline`` (the ``paper-infer`` run of the same cell) is printed
    beside it."""
    import dataclasses

    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import lstm_eval
    from repro_torch.nn.lstm import LSTMClassifier

    model = lstm_eval.build_model(config, dev, backend="cuda",
                                  analog_device=analog_device,
                                  bank_cols=bank_cols, seed=0,
                                  age_weights=age_weights)
    spec_ref = dataclasses.replace(
        model.spec, analog=model.spec.analog.replace(backend="ref"))
    ref = LSTMClassifier(spec_ref, model.fc_w.shape[1],
                         params=model.params(), device=dev)
    all_steps = config == "ptb_lstm"
    if all_steps:
        data = lstm_eval.ptb_batches(n_batches, batch, seq, dev)
    else:
        data = lstm_eval.kws_batches(n_batches, batch, dev)
    n_steps = n_batches * data[0][0].shape[1]

    lstm_eval.evaluate(model, data[:1], all_steps=all_steps, seed=7)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    lstm_cell.lstm_gates.launches = 0
    res = lstm_eval.evaluate(model, data, all_steps=all_steps, seed=1)
    launches = lstm_cell.lstm_gates.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cell = f"{config}/{analog_device}/bank_cols={bank_cols}"
    check(launches == n_steps,
          f"{cell}: lstm_gates launched {launches} times, expected "
          f"{n_steps}")
    res_ref = lstm_eval.evaluate(ref, data, all_steps=all_steps, seed=1)
    # the host clock spreads: repeat the timed run, report the median
    step_ms = [res["step_ms"]] + [
        lstm_eval.evaluate(model, data, all_steps=all_steps,
                           seed=1)["step_ms"] for _ in range(TIMING_REPEATS)]

    n_classes = model.fc_w.shape[1]
    diff = 0.0
    for lk, lr in zip(res["logits"], res_ref["logits"]):
        want = (batch, seq, n_classes) if all_steps else (batch, n_classes)
        check(tuple(lk.shape) == want, f"{config}: logits {tuple(lk.shape)}")
        check(bool(torch.isfinite(lk).all()), f"{config}: non-finite logits")
        diff = max(diff, float((lk - lr).abs().max()))
    check(diff <= LOGIT_ATOL,
          f"{cell}: logits differ from the ref backend by {diff} > "
          f"{LOGIT_ATOL}")
    suffix = "" if analog_device == "paper-infer" else "_ir"
    out = {"phase": config.split("_")[0] + suffix, "config": config,
           "analog_device": analog_device, "age_weights": age_weights,
           "bank_cols": bank_cols,
           "n_banks": -(-model.spec.n_hidden // bank_cols) if bank_cols
           else 1,
           "batches": n_batches, "B": batch, "T": data[0][0].shape[1],
           "launches": launches, "expected_launches": n_steps,
           "max_abs_logit_diff_vs_ref": diff, "logit_atol": LOGIT_ATOL,
           "nll": res["nll"], "bpc": res["nll"] / math.log(2.0),
           "accuracy": res["accuracy"],
           "step_ms": statistics.median(step_ms),
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "tokens_per_s": batch * 1e3 / statistics.median(step_ms),
           "ref_step_ms": res_ref["step_ms"], "peak_memory_gb": peak_gb}
    if baseline is not None:
        out["paper_infer"] = {k: baseline[k] for k in (
            "bpc", "accuracy", "step_ms", "step_ms_min", "step_ms_max")}
    emit(out)
    return out


# float32 operations per conductance in one sweep of the single-sourced
# line_drop and its attenuation: the µS -> S scale (1); the wordline's two
# prefix sums, the product g*(j+1), P_end - P_j, its product by j+1, the add
# and the product by r_wl (7); the bitline's seven in the same pattern (7);
# d_wl + d_bl (1); then 1 + d and its reciprocal (2).
SWEEP_OPS = 1 + 7 + 7 + 1 + 2


def ir_bound(n_in: int, n_out: int, n_iter: int) -> dict:
    """The least time the card needs for one IR correction of an
    (n_in, n_out) float32 matrix: w read once and the effective weights
    written once at the HBM rate, against its float32 operations.  Per
    weight and polarity, 1 + n_iter sweeps of SWEEP_OPS each, n_iter
    products g*s, and 10 more for the pair mapping and the
    recombination."""
    n = n_in * n_out
    n_bytes = 2 * 4 * n
    n_ops = n * (2 * ((1 + n_iter) * SWEEP_OPS + n_iter) + 10)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_ir(torch, dev, preset: str, name: str, shape) -> tuple:
    """The tiled IR correction on the card against the same function in
    float64 on the host, at a PTB weight's shape (its trunc-normal init
    plus one read-noise draw, as the step hands it over)."""
    import numpy as np

    from repro_torch.core import crossbar
    from repro_torch.core.device import get_device
    from repro_torch.nn.layers import trunc_normal

    ln = get_device(preset).line
    gen = torch.Generator(device=dev)
    gen.manual_seed(shape[0] * 10_000 + shape[1])
    w = trunc_normal(gen, shape) + crossbar.READ_SIGMA_W * torch.randn(
        shape, generator=gen, device=dev)
    plan = crossbar.plan_tiles(*shape)
    tile_shapes = sorted({(rs.stop - rs.start, cs.stop - cs.start)
                          for _, rs, cs in plan.blocks()})

    def call():
        return crossbar.ir_effective_weights_tiled(
            w, ln.r_wl_ohm, ln.r_bl_ohm, ln.sourcing, ln.n_iter)

    got = call()
    torch.cuda.synchronize()
    want = crossbar.ir_effective_weights_tiled(
        w.cpu().double(), ln.r_wl_ohm, ln.r_bl_ohm, ln.sourcing, ln.n_iter)
    got_np, want_np = got.cpu().double().numpy(), want.numpy()
    spacing = np.spacing(np.abs(want_np).astype(np.float32)).astype(
        np.float64)
    ulps = float(np.max(np.abs(got_np - want_np) / spacing))
    check(bool(torch.isfinite(got).all()), f"ir {preset}/{name}: non-finite")
    check(ulps <= IR_ULPS, f"ir {preset}/{name}: {ulps} float32 ulps from "
          f"float64 > {IR_ULPS}")
    out = {"phase": "ir", "case": f"{preset}/{name}", "shape": list(shape),
           "r_wl_ohm": ln.r_wl_ohm, "r_bl_ohm": ln.r_bl_ohm,
           "sourcing": ln.sourcing, "n_iter": ln.n_iter,
           "tiles": plan.n_crossbars, "tile_shapes": tile_shapes,
           "max_ulps_vs_f64": ulps, "ulp_bound": IR_ULPS,
           "max_abs_err": float(np.max(np.abs(got_np - want_np))),
           "max_abs_correction": float(np.max(np.abs(want_np - np.clip(
               w.cpu().double().numpy(), -2, 2)))),
           "call_ms": cuda_ms(call, reps=10, inner=10),
           **ir_bound(*shape, ln.n_iter)}
    emit(out)
    return out, call


def phase_ir_time(torch, case: dict, call) -> dict:
    """Kernels launched by one IR call and its device time per call
    (``device_ms``), after the main paths as ``kernel_time``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    ms, clock = device_ms(call, calls=10)
    out = {"phase": "ir_time", "case": case["case"],
           "launches_per_call": launches, "ms": ms, "timed_by": clock,
           "call_ms": case["call_ms"], "bound_ms": case["bound_ms"],
           "bound_by": case["bound_by"]}
    emit(out)
    case.update(launches_per_call=launches, ms=ms, timed_by=clock)
    return case


def matmul_bound(m: int, k: int, n: int, p: int, banked: bool,
                 x_bytes: int, bias: bool) -> dict:
    """The least time the card needs for one fused_matmul_nladc call on the
    route the kernel takes: x, w, bias, thresholds and table read once and
    the output written once, against its operations at their unit's rate.
    At M <= 8 (the GEMV) the 2*M*K*N multiply-adds and the M*N*P compares
    run on the float32 CUDA cores.  At M > 8 (the GEMM) each multiply-add
    is 3 (bfloat16 x) or 9 (float32 x) exact products of bfloat16 parts on
    the tensor cores, at the bfloat16 rate, and the compares run on the
    CUDA cores beside them (the larger of the two times).  ``bound_f32_ms``
    is the whole function at the float32 CUDA-core rate: a float32 SIMT
    kernel's bound, printed beside the route's."""
    from repro_torch.kernels.tune import GEMV_MAX_ROWS

    n_bytes = (x_bytes * m * k + 4 * k * n + (4 * n if bias else 0)
               + 4 * (n * p if banked else p) + 4 * (p + 1)
               + x_bytes * m * n)
    mac, cmp = 2 * m * k * n, m * n * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_f32 = (mac + cmp) / H100_F32_OPS_PER_S * 1e3
    if m > GEMV_MAX_ROWS:
        products = 3 if x_bytes == 2 else 9
        route, n_ops = "tensor cores, bfloat16 split", mac * products + cmp
        t_ops = max(mac * products / H100_BF16_OPS_PER_S,
                    cmp / H100_F32_OPS_PER_S) * 1e3
    else:
        route, n_ops, t_ops = "float32 CUDA cores", mac + cmp, t_f32
    return {"route": route, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": max(t_bytes, t_f32)}


def phase_fused_matmul(torch, dev, name: str, m: int, k: int, n: int,
                       x_dtype, bank_cols: int, bias: bool = False,
                       reps: int = 20, inner: int = 50):
    """The fused matmul kernel against its plain version; the kernel's
    codes come from a second launch with the counting table y(n) = n.
    ``reps`` x ``inner`` calls time it (CUDA events)."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="infer", device="paper-infer",
                       bank_cols=bank_cols)
    act = AnalogActivation("silu", cfg, dev)
    thr = act.thresholds_for(n)
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    y_table = act.adc.y_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 100_000 + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    w = (2.0 / math.sqrt(k)) * torch.randn((k, n), generator=gen,
                                           device=dev)
    b = 0.5 * torch.randn((n,), generator=gen, device=dev) if bias else None
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = fmn.fused_matmul_nladc(x, w, b, thr, y_table)
    nk = fmn.fused_matmul_nladc(x, w, b, thr, count).long()
    yp = fmn.fused_matmul_nladc_plain(x, w, b, thr, y_table)
    n_plain = thermometer_count(x.float() @ w + (b if bias else 0.0), thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(x, w, b)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"{name}: output dtype {yk.dtype} or non-finite values")
    check(torch.equal(yk, y_table[nk].to(x_dtype)),
          f"{name}: kernel output is not the table at its codes")
    check(unexplained == 0,
          f"{name}: {unexplained} code flips beyond float32 rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"{name}: {flips} code flips of {nk.numel()}")

    xf = x.float()

    def kernel():
        return fmn.fused_matmul_nladc(x, w, b, thr, y_table)

    def plain():
        return fmn.fused_matmul_nladc_plain(x, w, b, thr, y_table)

    def library():
        return torch.matmul(xf, w)

    out = {"phase": "fused_matmul", "case": name, "M": m, "K": k, "N": n,
           "P": p, "x_dtype": str(x_dtype).replace("torch.", ""),
           "bias": bias, "layout": "(N,P)" if banked else "(P,)",
           "code_flips": flips, "unexplained_flips": unexplained,
           "elements": nk.numel(), "max_abs_err": err,
           "call_ms": cuda_ms(kernel, reps=reps, inner=inner),
           "plain_call_ms": cuda_ms(plain, reps=reps, inner=min(inner, 5)),
           **matmul_bound(m, k, n, p, banked, x.element_size(), bias)}
    emit(out)
    return out, kernel, plain, library


def bf16_ulp(torch, a):
    """One bfloat16 ulp at |a| (8 significant bits)."""
    a = a.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def attention_bound(b: int, h: int, hkv: int, d: int, s_len: int,
                    elem_bytes: int) -> dict:
    """The least time the card needs for one prefill_attention call: q,
    the K/V cache and the mask read once, the output written once, against
    the QK and PV multiply-adds (and ~5 softmax operations a score) at the
    rate of the inputs' type (bfloat16 tensor cores, or float32)."""
    n_bytes = elem_bytes * (2 * b * h * d + 2 * b * s_len * hkv * d) \
        + 4 * b * s_len
    n_ops = 4 * b * h * s_len * d + 5 * b * h * s_len
    rate = H100_BF16_OPS_PER_S if elem_bytes == 2 else H100_F32_OPS_PER_S
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_attention(torch, dev, name: str, dtype, s_len: int):
    """The cached-attention kernel against its plain version at the serving
    path's heads, ragged masks (one row sees a single slot)."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa

    b, h, hkv, d = SERVE["max_batch"], 16, 2, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    lengths = torch.tensor([s_len, 1, 37 * s_len // 128, 100 * s_len // 128],
                           device=dev)
    mask = (torch.arange(s_len, device=dev)[None] < lengths[:, None]).to(
        torch.int32)
    ok = pa.prefill_attention(q, k, v, mask)
    op = pa.prefill_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (ok.float() - op.float()).abs()
    err = float(diff.max())
    check(ok.dtype == dtype and bool(torch.isfinite(ok.float()).all()),
          f"{name}: output dtype {ok.dtype} or non-finite values")
    if dtype == torch.float32:
        check(err <= ATTN_F32_ATOL, f"{name}: max abs diff {err}")
        ulps = None
    else:
        ulp = bf16_ulp(torch, torch.maximum(ok.float().abs(),
                                            op.float().abs()))
        ulps = float((diff / ulp).max())
        check(ulps <= 1.0, f"{name}: {ulps} bfloat16 ulps apart")

    # the yardstick: one PyTorch call for the same attention, in its layout
    qs = q[:, :, None].contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    ms = (mask != 0)[:, None, None, :]

    def kernel():
        return pa.prefill_attention(q, k, v, mask)

    def plain():
        return pa.prefill_attention_plain(q, k, v, mask)

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms,
                                              enable_gqa=True)

    lib_diff = float((library()[:, :, 0].float() - op.float()).abs().max())
    out = {"phase": "attention", "case": name, "B": b, "H": h, "Hkv": hkv,
           "D": d, "S": s_len, "dtype": str(dtype).replace("torch.", ""),
           "cluster": pa.cluster_size(h, hkv, d, s_len, dtype),
           "max_abs_err": err, "max_bf16_ulps": ulps,
           "library_max_abs_diff": lib_diff,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **attention_bound(b, h, hkv, d, s_len, q.element_size())}
    emit(out)
    return out, kernel, plain, library


def phase_serve(torch, dev, name: str = "serve", analog_mode: str = "",
                analog_device: str = "", repeats: int = SERVE["repeats"]
                ) -> dict:
    """qwen2.5-3b at full width and depth on the cuda backend, in the
    spec's analog mode or ``analog_mode`` on ``analog_device``."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE["arch"], backend="cuda",
                            analog_mode=analog_mode,
                            analog_device=analog_device)
    model, params = serve.build_lm(cfg, dev, seed=0)
    engine = ServingEngine(model, params, max_batch=SERVE["max_batch"],
                           max_len=SERVE["max_len"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up

    # the counted run: every step's logits must be finite
    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model.decode_step = checked
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = engine.run_offline(reqs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    expected = {k: cfg.n_layers * steps
                if k in ("fused_matmul_nladc", "prefill_attention") else 0
                for k in wrappers}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          f"{name}: non-finite logits")
    check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
          f"{name}: token counts {[len(r.generated) for r in reqs]}")

    runs = [engine.run_offline(serve.make_requests(
        cfg, SERVE["requests"], SERVE["max_new"]))
        for _ in range(repeats)]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "dtype": cfg.dtype, "backend": "cuda",
           "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device, **{
               k: SERVE[k] for k in ("requests", "max_batch", "max_len",
                                     "max_new")},
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": expected,
           "streams": {r.uid: r.generated for r in reqs},
           "repeats": len(runs),
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "decode_step_ms": statistics.median(dms),
           "decode_step_ms_min": min(dms), "decode_step_ms_max": max(dms),
           "prefill_step_ms": statistics.median(pms),
           "prefill_step_ms_min": min(pms), "prefill_step_ms_max": max(pms),
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(out)
    return out


def phase_agreement(torch, dev, name: str = "agreement",
                    analog_mode: str = "", analog_device: str = "") -> dict:
    """A 2-layer, full-width, float32 variant on the cuda and ref backends:
    the same weights and tokens, max |delta logits| < LSB/2."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(
            SERVE["arch"], backend=bk, analog_mode=analog_mode,
            analog_device=analog_device).replace(n_layers=AGREE_LAYERS,
                                                 dtype="float32")
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    b = SERVE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(b, SERVE["max_len"])
              for bk, m in models.items()}
    worst = 0.0
    for t in range(AGREE_STEPS):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(params, states[bk],
                                                   tokens[t])
        check(bool(torch.isfinite(logits["cuda"]).all()),
              f"{name}: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"{name}: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    out = {"phase": name, "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device,
           "n_layers": AGREE_LAYERS, "dtype": "float32",
           "B": b, "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2}
    emit(out)
    return out


def nladc_bound(numel: int, n_cols: int, p: int, banked: bool,
                x_bytes: int) -> dict:
    """The least time the card needs for one nladc call: x, thresholds and
    table read once and the output written once, against the P compares
    of every element at the float32 rate."""
    n_bytes = 2 * x_bytes * numel + 4 * (n_cols * p if banked else p) \
        + 4 * (p + 1)
    n_ops = numel * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_nladc(torch, dev, name: str, shape, act_name: str, x_dtype,
                bank_cols: int):
    """The elementwise NL-ADC kernel against its plain version: codes
    (from a launch with the counting table) and values bitwise."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import nladc as nk
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="exact", device="ideal", bank_cols=bank_cols)
    act = AnalogActivation(act_name, cfg, dev)
    thr = act.thresholds_for(shape[-1])
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(shape))
    x = 2.5 * torch.randn(shape, generator=gen, device=dev)
    # inputs exactly on thresholds exercise the strict comparator
    x.view(-1)[:p] = thr.reshape(-1, p)[0]
    x = x.to(x_dtype)
    y_table = act.adc.y_table
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = nk.nladc(x, thr, y_table)
    ck = nk.nladc(x, thr, count)
    yp = nk.nladc_plain(x, thr, y_table)
    cp = thermometer_count(x, thr)
    torch.cuda.synchronize()
    mismatches = int((ck.long() != cp).sum())
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and yk.shape == x.shape,
          f"nladc/{name}: output {yk.dtype} {tuple(yk.shape)}")
    check(mismatches == 0, f"nladc/{name}: {mismatches} codes differ")
    check(torch.equal(yk, yp), f"nladc/{name}: values differ (max {err})")

    def kernel():
        return nk.nladc(x, thr, y_table)

    def plain():
        return nk.nladc_plain(x, thr, y_table)

    out = {"phase": "nladc", "case": name, "shape": list(shape), "P": p,
           "x_dtype": str(x_dtype).replace("torch.", ""),
           "layout": "(N,P)" if banked else "(P,)",
           "code_mismatches": mismatches, "max_abs_err": err,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **nladc_bound(x.numel(), shape[-1], p, banked, x.element_size())}
    emit(out)
    return out, kernel, plain, None


def moe_bound(e: int, c: int, k: int, n: int, p: int, banked: bool,
              x_bytes: int, live: int) -> dict:
    """The least time the card needs for one moe_fused_matmul call: every
    expert's x read once, the weight of the ``live`` experts (those with a
    nonzero capacity row; an empty expert's outputs need none of it) read
    once, thresholds and table once, the output written once, against the
    live experts' 2*live*C*K*N multiply-adds and E*C*N*P compares at the
    float32 rate (the weight is float32)."""
    n_bytes = (x_bytes * e * c * k + 4 * live * k * n
               + 4 * (n * p if banked else p) + 4 * (p + 1)
               + x_bytes * e * c * n)
    n_ops = 2 * live * c * k * n + e * c * n * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def serving_fill(torch, gen, dev, e: int, k: int, dtype, tokens: int = 4,
                 top_k: int = 6):
    """The expert buffer of one moonshot decode step: ``tokens`` tokens
    routed to the top-k of random router scores, gathered by
    ``dispatch_plan`` / ``gather_expert_buffer`` at the model's capacity
    (capacity factor 1.0: C 6 at B 4, top-6, 64 experts); the capacity
    rows no token fills are zeros."""
    from repro_torch.nn import moe as M

    xf = torch.randn((tokens, k), generator=gen, device=dev).to(dtype)
    scores = torch.rand((tokens, e), generator=gen, device=dev)
    gates, idx = M.stable_top_k(scores, top_k)
    cap = M.expert_capacity(tokens, top_k, e, 1.0)
    st, _, dest, valid = M.dispatch_plan(idx, gates, tokens, e, cap)
    return M.gather_expert_buffer(xf, st, dest, valid, e, cap)


def phase_moe_matmul(torch, dev, name: str, e: int, c: int, k: int, n: int,
                     x_dtype, bank_cols: int, fill: str = "all"):
    """The grouped expert-gate kernel against its plain version, with the
    fused matmul's contract; codes from a launch with the counting table.
    ``fill``: ``all`` (random x, one empty capacity row), ``serving``
    (the expert buffer of a decode step at B 4, top-6) or ``none`` (every
    capacity row +0.0 or -0.0: no expert live)."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="infer", device="paper-infer",
                       bank_cols=bank_cols)
    act = AnalogActivation("silu", cfg, dev)
    thr = act.thresholds_for(n)
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    y_table = act.adc.y_table
    gen = torch.Generator(device=dev)
    gen.manual_seed(e * 100_000 + n)
    if fill == "serving":
        x = serving_fill(torch, gen, dev, e, k, x_dtype)
        check(tuple(x.shape) == (e, c, k),
              f"{name}: the serving fill is {tuple(x.shape)}")
    else:
        x = torch.randn((e, c, k), generator=gen, device=dev).to(x_dtype)
        x[0, -1] = 0                              # an empty capacity row
        if fill == "none":
            x.mul_(0)                             # +0.0 and -0.0
    live = int((x != 0).any(-1).any(-1).sum())
    w = (2.0 / math.sqrt(k)) * torch.randn((e, k, n), generator=gen,
                                           device=dev)
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = fmn.moe_fused_matmul(x, w, thr, y_table)
    nk = fmn.moe_fused_matmul(x, w, thr, count).long()
    yp = fmn.moe_fused_matmul_plain(x, w, thr, y_table)
    xf = x.float()
    n_plain = thermometer_count(torch.bmm(xf, w), thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(x, w)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    del acc, bound
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"{name}: output dtype {yk.dtype} or non-finite values")
    check(torch.equal(yk, y_table[nk].to(x_dtype)),
          f"{name}: kernel output is not the table at its codes")
    check(unexplained == 0,
          f"{name}: {unexplained} code flips beyond float32 rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"{name}: {flips} code flips of {nk.numel()}")
    zero_rows = (x == 0).all(-1)
    zero = thermometer_count(torch.zeros(n, device=dev), thr)
    check(torch.equal(nk[zero_rows], zero.expand(int(zero_rows.sum()), -1)),
          f"{name}: empty capacity rows are not the table at the zero code")

    def kernel():
        return fmn.moe_fused_matmul(x, w, thr, y_table)

    def plain():
        return fmn.moe_fused_matmul_plain(x, w, thr, y_table)

    def library():
        return torch.bmm(xf, w)

    out = {"phase": "moe_matmul", "case": name, "E": e, "C": c, "K": k,
           "N": n, "P": p, "x_dtype": str(x_dtype).replace("torch.", ""),
           "layout": "(N,P)" if banked else "(P,)", "fill": fill,
           "live_experts": live, "blocks": list(tune.launch_config(
               "fused_matmul_nladc", (c, k, n), x_dtype, dev,
               experts=e)),
           "code_flips": flips, "unexplained_flips": unexplained,
           "elements": nk.numel(), "max_abs_err": err,
           "call_ms": cuda_ms(kernel, reps=10, inner=10),
           "plain_call_ms": cuda_ms(plain, reps=5, inner=2),
           **moe_bound(e, c, k, n, p, banked, x.element_size(), live)}
    emit(out)
    return out, kernel, plain, library


def flash_bound(lengths, h: int, hkv: int, d: int, q_bytes: int,
                s_len: int) -> dict:
    """The least time the card needs for one flash_decode_int8 call with
    these lengths: q, the slots it attends to (the valid ones; all S of a
    row of length 0) with their int8 K/V and bfloat16 scales and the
    lengths read once, the float32 output written once, against the QK and
    PV multiply-adds (and ~5 softmax operations a score) at the rate of q's
    type (bfloat16 tensor cores, or float32)."""
    b = len(lengths)
    slots = sum(min(n, s_len) if n > 0 else s_len for n in lengths)
    n_bytes = q_bytes * b * h * d + slots * hkv * (2 * d + 2 * 2) + 4 * b \
        + 4 * b * h * d
    n_ops = 4 * h * d * slots + 5 * h * slots
    rate = H100_BF16_OPS_PER_S if q_bytes == 2 else H100_F32_OPS_PER_S
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_flash_decode(torch, dev, name: str, b: int, h: int, hkv: int,
                       d: int, s_len: int, lengths, q_dtype):
    """The int8 flash-decode kernel against its plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import inv_sqrt_d

    gen = torch.Generator(device=dev)
    gen.manual_seed(s_len * 100 + hkv)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k8, v8 = (torch.randint(-127, 128, (b, s_len, hkv, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((1e-3 + 2e-2 * torch.rand((b, s_len, hkv), generator=gen,
                                        device=dev)).bfloat16()
              for _ in range(2))
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ok = fd.flash_decode_int8(q, k8, ks, v8, vs, length)
    op = fd.flash_decode_int8_plain(q, k8, ks, v8, vs, length)
    torch.cuda.synchronize()
    err = float((ok - op).abs().max())
    check(ok.dtype == torch.float32 and bool(torch.isfinite(ok).all()),
          f"flash_decode/{name}: output dtype {ok.dtype} or non-finite")
    check(err <= FLASH_ATOL, f"flash_decode/{name}: max abs diff {err}")

    # the yardstick: one PyTorch call for the attention alone, over K/V
    # dequantized beforehand, in its layout
    qs = q.float()[:, :, None]
    kd = (k8.float() * ks.float()[..., None]).transpose(1, 2).contiguous()
    vd = (v8.float() * vs.float()[..., None]).transpose(1, 2).contiguous()
    ms = (torch.arange(s_len, device=dev)[None] < length[:, None])[
        :, None, None, :]
    scale = float(inv_sqrt_d(d))

    def kernel():
        return fd.flash_decode_int8(q, k8, ks, v8, vs, length)

    def plain():
        return fd.flash_decode_int8_plain(q, k8, ks, v8, vs, length)

    def library():
        return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=ms,
                                              enable_gqa=True, scale=scale)

    lib_diff = float((library()[:, :, 0] - op).abs().max())
    out = {"phase": "flash_decode", "case": name, "B": b, "H": h,
           "Hkv": hkv, "D": d, "S": s_len, "lengths": list(lengths),
           "q_dtype": str(q_dtype).replace("torch.", ""),
           "splits": fd.split_count(b, hkv, s_len),
           "max_abs_err": err, "atol": FLASH_ATOL,
           "library_max_abs_diff": lib_diff,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **flash_bound(lengths, h, hkv, d, q.element_size(), s_len)}
    emit(out)
    return out, kernel, plain, library


def tile_bound(m: int, k: int, n: int, p: int, x_bytes: int, noise: bool,
               pwm: bool) -> dict:
    """The least time the card needs for one analog_tile call: x, w, the
    noise and the thresholds read once and the output written once,
    against the 2*M*K*N multiply-adds, the noise adds, the PWM (clamp,
    scale, round, scale: 4 a value of x), M*N*P compares and the M*N
    decodes at the float32 rate (the weight is float32)."""
    n_bytes = x_bytes * m * k + 4 * k * n * (2 if noise else 1) + 4 * p \
        + x_bytes * m * n
    n_ops = 2 * m * k * n + (k * n if noise else 0) + \
        (4 * m * k if pwm else 0) + m * n * p + 2 * m * n
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_analog_tile(torch, dev, name: str, m: int, k: int, n: int,
                      x_dtype, bits, noise: bool, act: str):
    """The crossbar-tile kernel against its plain version, with the fused
    matmul's flip contract on the effective operands; codes from a launch
    that decodes y(n) = n."""
    from repro_torch.core.nladc import build_ramp
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import (ClosedForm, closed_form_decode_fma,
                                        closed_form_params,
                                        effective_operands,
                                        thermometer_count)

    ramp = build_ramp(act, 5)
    dec = closed_form_params(ramp)
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32, device=dev)
    p = thr.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 100_000 + n)
    x = (0.6 * torch.randn((m, k), generator=gen, device=dev)).to(x_dtype)
    w = (2.0 / math.sqrt(k)) * torch.randn((k, n), generator=gen,
                                           device=dev)
    nz = 0.02 * torch.randn((k, n), generator=gen, device=dev) \
        if noise else None
    yk = at.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits)
    nk = at.analog_tile(x, w, thr, ClosedForm(0, 0.0, 1.0, 1.0, 0),
                        w_noise=nz, input_bits=bits).float().long()
    yp = at.analog_tile_plain(x, w, nz, thr, dec, bits)
    xq, w_eff = effective_operands(x, w, nz, bits)
    n_plain = thermometer_count(xq @ w_eff, thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(xq, w_eff)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    del acc, bound
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"analog_tile/{name}: output dtype {yk.dtype} or non-finite")
    check(torch.equal(yk, closed_form_decode_fma(nk.float(), dec)
                      .to(x_dtype)),
          f"analog_tile/{name}: output is not the decode at its codes")
    check(unexplained == 0,
          f"analog_tile/{name}: {unexplained} code flips beyond float32 "
          f"rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"analog_tile/{name}: {flips} code flips of {nk.numel()}")

    def kernel():
        return at.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits)

    def plain():
        return at.analog_tile_plain(x, w, nz, thr, dec, bits)

    def library():
        return torch.matmul(xq, w_eff)

    out = {"phase": "analog_tile", "case": name, "M": m, "K": k, "N": n,
           "P": p, "x_dtype": str(x_dtype).replace("torch.", ""),
           "input_bits": bits, "noise": noise, "ramp": act,
           "decode_mode": dec.mode, "code_flips": flips,
           "unexplained_flips": unexplained, "elements": nk.numel(),
           "blocks": list(tune.launch_config("analog_tile", (m, k, n),
                                             x_dtype, dev)),
           "max_abs_err": err, "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **tile_bound(m, k, n, p, x.element_size(), noise,
                        bits is not None)}
    emit(out)
    return out, kernel, plain, library


def phase_kernel_tune(torch, dev) -> dict:
    """The kernel-autotune entry point on the card, its launches, and the
    host cost of the tune seam per wrapper call."""
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.launch import kernel_tune

    wrappers = _tune_path_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = kernel_tune.run(True, dev)
    sweep_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    path = ("analog_tile", "fused_matmul_nladc", "nladc", "lstm_gates",
            "moe_fused_matmul", "prefill_attention")
    check(all(launches[k] > 0 for k in path),
          f"kernel_tune: a kernel of the path never launched: {launches}")
    entries = res["tune"]["entries"]
    check(all(e["source"] == "measured" for e in entries.values()),
          "kernel_tune: a shape was not measured on the card")
    for key, cell in res["shapes"].items():
        if cell["code_flips"] is not None:
            check(cell["unexplained_flips"] == 0,
                  f"kernel_tune/{key}: unexplained code flips")
    par = res["parity"]
    check(par["banked"]["bitwise_equal"] and
          par["moe_einsum"]["within_half_lsb"] and
          par["attention"]["within_atol"] and
          all(0.0 <= par[k]["grad_max_err"] <= GRAD_HALF_ATOL
              for k in ("moe_einsum", "attention")),
          f"kernel_tune: parity section failed: {par}")

    # host time per wrapper call, the seam resolving from the sweep's cache
    # or to the default (ABBA, median of repeats; no sync inside a timing)
    cache = tune.TuneCache.from_dict(res["tune"])
    m, k, n = 4, 2048, 11008
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
    thr = torch.linspace(-1, 1, 31, device=dev)
    y_table = torch.linspace(-1, 1, 32, device=dev)

    def host_us(active):
        tune.set_active_cache(active)
        fmn.fused_matmul_nladc(x, w, None, thr, y_table)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            fmn.fused_matmul_nladc(x, w, None, thr, y_table)
        us = (time.perf_counter() - t) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            tune.launch_config("fused_matmul_nladc", (m, k, n), x.dtype,
                               x.device)
        return us, (time.perf_counter() - t) / HOST_CALLS * 1e6

    runs = {"none": [], "cache": []}
    for _ in range(HOST_REPEATS):
        for which in ("none", "cache", "cache", "none"):
            runs[which].append(host_us(cache if which == "cache" else None))
    tune.set_active_cache(None)
    host = {which: {"call_us": statistics.median(r[0] for r in rs),
                    "call_us_min": min(r[0] for r in rs),
                    "call_us_max": max(r[0] for r in rs),
                    "resolve_us": statistics.median(r[1] for r in rs)}
            for which, rs in runs.items()}
    shapes = {key: {k: c[k] for k in (
        "blocks", "default", "us", "sweep_us", "default_us", "candidates",
        "digest", "code_flips")} for key, c in res["shapes"].items()}
    out = {"phase": "kernel_tune", "sweep_s": sweep_s,
           "shapes_swept": len(entries),
           "candidates": sum(e["candidates"] for e in entries.values()),
           "candidates_bitwise_default": True, "launches": launches,
           "shapes": shapes, "parity": par,
           "host_fused_matmul_m4": {"calls": HOST_CALLS,
                                    "repeats": 2 * HOST_REPEATS,
                                    "tuned_blocks": list(cache.lookup(
                                        "fused_matmul_nladc", (m, k, n),
                                        x.dtype, dev)), **host}}
    emit(out)
    return out


def _wrappers():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import nladc as nk
    from repro_torch.kernels import prefill_attention as pa

    return {"nladc": nk.nladc, "moe_fused_matmul": fmn.moe_fused_matmul,
            "flash_decode_int8": fd.flash_decode_int8,
            "fused_matmul_nladc": fmn.fused_matmul_nladc,
            "prefill_attention": pa.prefill_attention}


def _tune_path_wrappers():
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import lstm_cell

    return {**_wrappers(), "analog_tile": at.analog_tile,
            "lstm_gates": lstm_cell.lstm_gates}


def phase_serve_moe(torch, dev) -> dict:
    """moonshot-v1-16b-a3b at full width, 24 layers, int8 KV cache, on the
    cuda backend."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE_MOE["arch"], backend="cuda", overrides={
        "n_layers": SERVE_MOE["n_layers"],
        "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"]})
    torch.cuda.reset_peak_memory_stats(dev)
    model, params = serve.build_lm(cfg, dev, seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    engine = ServingEngine(model, params, max_batch=SERVE_MOE["max_batch"],
                           max_len=SERVE_MOE["max_len"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up

    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model.decode_step = checked
    reqs = serve.make_requests(cfg, SERVE_MOE["requests"],
                               SERVE_MOE["max_new"])
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = engine.run_offline(reqs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    expected = {k: 0 if k == "prefill_attention" else cfg.n_layers * steps
                for k in wrappers}
    check(launches == expected,
          f"serve_moe: launches {launches}, expected {expected}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          "serve_moe: non-finite logits")
    check(all(len(r.generated) == SERVE_MOE["max_new"] for r in reqs),
          f"serve_moe: token counts {[len(r.generated) for r in reqs]}")
    check(all(t["k"].dtype == torch.int8 for t in engine.state["layers"]),
          "serve_moe: the KV cache is not int8")

    runs = [engine.run_offline(serve.make_requests(
        cfg, SERVE_MOE["requests"], SERVE_MOE["max_new"]))
        for _ in range(SERVE_MOE["repeats"])]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    out = {"phase": "serve_moe", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "params": n_params, "params_gb_f32": 4 * n_params / 1e9,
           "kv_cache_dtype": cfg.kv_cache_dtype, "dtype": cfg.dtype,
           "backend": "cuda", **{k: SERVE_MOE[k] for k in (
               "requests", "max_batch", "max_len", "max_new")},
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": expected,
           "streams": {r.uid: r.generated for r in reqs},
           "repeats": len(runs),
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "decode_step_ms": statistics.median(dms),
           "decode_step_ms_min": min(dms), "decode_step_ms_max": max(dms),
           "prefill_step_ms": statistics.median(pms),
           "prefill_step_ms_min": min(pms), "prefill_step_ms_max": max(pms),
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(out)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_agreement_moe(torch, dev) -> dict:
    """A 2-layer, full-width, float32 moonshot with an int8 cache on the
    cuda and ref backends: the same weights and tokens, max |delta logits|
    < LSB/2."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(SERVE_MOE["arch"], backend=bk, overrides={
            "n_layers": AGREE_LAYERS,
            "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"]}).replace(
                dtype="float32")
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    params = models["cuda"].init(gen)
    b = SERVE_MOE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(b, SERVE_MOE["max_len"])
              for bk, m in models.items()}
    worst = 0.0
    for t in range(AGREE_STEPS):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(params, states[bk],
                                                   tokens[t])
        check(bool(torch.isfinite(logits["cuda"]).all()),
              "agreement_moe: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"agreement_moe: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    out = {"phase": "agreement_moe", "arch": SERVE_MOE["arch"],
           "n_layers": AGREE_LAYERS, "dtype": "float32",
           "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"], "B": b,
           "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2}
    emit(out)
    return out


def phase_train_lm(torch, dev, name: str, spec: dict, path: dict,
                   bank_cols: int = 0) -> dict:
    """LM training at full width on the cuda backend through
    ``repro_torch.launch.train`` (AdamW, clip 1.0, remat per layer), train
    mode on ``spec``'s preset: every step's loss finite, each kernel of
    ``path`` launched ``path[k]`` times a step (2 a layer: the forward and
    its recompute), the others never; ms per step (the steps after the
    first), tokens/s, peak device memory under the card's 80 GB."""
    from repro_torch.launch import serve, train

    overrides = {"n_layers": spec["n_layers"]} if "n_layers" in spec else {}
    cfg = serve.make_config(spec["arch"], backend="cuda", bank_cols=bank_cols,
                            analog_mode="train",
                            analog_device=spec["analog_device"],
                            overrides=overrides)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, trainer, state = train.build_trainer(
        cfg, dev, steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
        log=None)
    n_params = sum(t.numel() for t in _leaves(state.params))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = train.train(trainer, state, spec["steps"], dev)
    hist = trainer.history
    expected = {k: path.get(k, 0) for k in wrappers}
    check(all(step == expected for step in res["launches"]),
          f"{name}: launches per step {res['launches']}, expected "
          f"{expected}")
    losses = [h["loss"] for h in hist]
    check(len(losses) == spec["steps"]
          and all(math.isfinite(v) for v in losses + [h["grad_norm"]
                                                       for h in hist]),
          f"{name}: non-finite losses or gradient norms {hist}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(peak_gb < CARD_GB, f"{name}: peak memory {peak_gb} GB")
    later = trainer.step_ms[1:]
    step_ms = statistics.median(later)
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "params": n_params, "dtype": cfg.dtype, "backend": "cuda",
           "analog_mode": "train", "analog_device": spec["analog_device"],
           "bank_cols": bank_cols, "B": spec["batch"], "S": spec["seq"],
           "steps": spec["steps"], "setup_s": setup_s, "losses": losses,
           "aux_losses": [h["aux_loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms_all": trainer.step_ms, "step_ms": step_ms,
           "step_ms_min": min(later), "step_ms_max": max(later),
           "tokens_per_s": spec["batch"] * spec["seq"] * 1e3 / step_ms,
           "launches_per_step": res["launches"][-1],
           "expected_launches_per_step": expected,
           "launches": {k: sum(r[k] for r in res["launches"])
                        for k in wrappers},
           "peak_memory_gb": peak_gb}
    emit(out)
    del model, trainer, state, res
    return out


def _wrap_gates(backend, on_output):
    """Route each outermost call of ``backend``'s gate primitives (the ref
    backend's fused gates call its ``nladc`` inside) through
    ``on_output(y, adc) -> y'``; returns the undo."""
    names = ("nladc", "matmul_nladc", "moe_matmul_nladc")
    saved = {n: getattr(backend, n) for n in names}
    depth = [0]

    def wrap(fn):
        def wrapped(*args, **kw):
            depth[0] += 1
            try:
                y = fn(*args, **kw)
            finally:
                depth[0] -= 1
            if depth[0]:
                return y
            adc = next(a for a in (*args, *kw.values())
                       if hasattr(a, "y_table"))
            return on_output(y, adc)
        return wrapped

    for n in names:
        setattr(backend, n, wrap(saved[n]))
    return lambda: [delattr(backend, n) for n in names]


def _grad_excess(torch, got, want) -> float:
    """The largest ``|got - want| - (atol + rtol |want|)`` over every leaf
    (<= 0: within TRAIN_RTOL / TRAIN_ATOL)."""
    return max(float(((g - w).abs() - TRAIN_ATOL - TRAIN_RTOL * w.abs())
                     .max()) for g, w in zip(got, want))


def _level_steps(torch, adc, got, want):
    """For each differing pair of NL-ADC outputs, the least distance
    between their codes in ``adc``'s (flat) decode table (1: adjacent
    levels, a single code flip; a value off the table counts as 10**9 or
    more)."""
    table = adc.y_table.to(device=got.device, dtype=got.dtype)
    if table.dim() != 1:
        raise ValueError("train_agreement compares flat NL-ADCs only")
    diff = got != want
    if not bool(diff.any()):
        return torch.zeros(0, dtype=torch.int64)
    idx = torch.arange(table.numel(), device=got.device)
    big = torch.full_like(idx, 10 ** 9)
    ig = torch.where(got[diff][:, None] == table, idx, big)
    iw = torch.where(want[diff][:, None] == table, idx, -big)
    dist = (ig[:, :, None] - iw[:, None, :]).abs()
    return dist.flatten(1).min(1).values.cpu()


def phase_train_agreement(torch, dev, arch: str,
                          seed: int = TRAIN_AGREE["seed"]) -> dict:
    """A 2-layer, full-width, float32 variant in train mode on the cuda
    and ref backends, the same weights and ramp draws (one generator
    state), three runs: cuda, ref, and ref given the cuda run's gate
    outputs (its own straight-through backward on its own accumulator,
    the forward values replaced).

    Forward: in the third run each gate sees the very inputs cuda's did,
    so its own outputs against cuda's are the code flips of the fused
    gate's float32 sum in another order than cuBLAS's: at most
    AGREE_FLIP_SHARE of the outputs, each one level of the decode table
    from cuda's (a wrong forward value is not one level away).  The
    outputs of the free cuda and ref runs differ at most as often.  The
    losses agree within TRAIN_RTOL / TRAIN_ATOL.

    Backward: against the third run within TRAIN_RTOL / TRAIN_ATOL
    whatever flipped; against ``ref`` itself within TRAIN_RTOL /
    TRAIN_ATOL where nothing flipped, and within that plus
    AGREE_FLIP_GRAD_EXCESS where codes flipped (a flip moves one output
    by an LSB, its straight-through mask and every gradient downstream)."""
    from repro_torch.core import backend as BK
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.launch import serve
    from repro_torch.nn.model import build
    from repro_torch.train import optim

    b, s = TRAIN_AGREE["batch"], TRAIN_AGREE["seq"]
    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(arch, backend=bk, analog_mode="train",
                                analog_device="paper", overrides={
                                    "n_layers": TRAIN_AGREE["n_layers"],
                                    "dtype": "float32"})
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = models["cuda"].init(gen)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    gates = {"cuda": [], "ref": []}
    same_inputs = {"flips": 0, "steps": []}

    def record(outputs):
        def on_output(y, adc):
            outputs.append(y.detach())
            return y
        return on_output

    def replay(y, adc):
        z = gates["cuda"][replay.i]
        replay.i += 1
        steps = _level_steps(torch, adc, z, y.detach())
        same_inputs["flips"] += steps.numel()
        same_inputs["steps"].append(steps)
        return z + (y - y.detach())       # cuda's values, ref's gradient
    replay.i = 0

    def run(bk, on_output):
        undo = _wrap_gates(BK.get_backend(bk), on_output)
        ng = torch.Generator(device=dev)
        ng.manual_seed(seed + 1)
        try:
            total, _ = models[bk].loss(params, batch,
                                       noise=GeneratorNoise(ng), remat=False)
        finally:
            undo()
        return float(total.detach()), torch.autograd.grad(total, leaves)

    loss_c, grad_c = run("cuda", record(gates["cuda"]))
    loss_r, grad_r = run("ref", record(gates["ref"]))
    loss_rc, grad_rc = run("ref", replay)
    n_gate = sum(a.numel() for a in gates["cuda"])
    flips = sum(int((a != r).sum()) for a, r in zip(gates["cuda"],
                                                    gates["ref"]))
    steps = torch.cat(same_inputs["steps"])
    max_step = int(steps.max()) if steps.numel() else 0
    out = {"phase": "train_agreement", "arch": arch, "seed": seed,
           "n_layers": TRAIN_AGREE["n_layers"], "dtype": "float32",
           "B": b, "S": s, "loss_cuda": loss_c, "loss_ref": loss_r,
           "loss_ref_on_cuda_codes": loss_rc, "leaves": len(leaves),
           "gate_calls": len(gates["cuda"]), "gate_outputs": n_gate,
           "code_flips": flips,
           "code_flips_same_inputs": same_inputs["flips"],
           "max_flip_levels": max_step, "max_flip_share": AGREE_FLIP_SHARE,
           "grad_rtol": TRAIN_RTOL, "grad_atol": TRAIN_ATOL,
           "grad_excess_limit_with_flips": AGREE_FLIP_GRAD_EXCESS,
           "grad_max_abs_diff_vs_ref": max(
               float((g - w).abs().max()) for g, w in zip(grad_c, grad_r)),
           "grad_excess_vs_ref": _grad_excess(torch, grad_c, grad_r),
           "grad_max_abs_diff_vs_ref_on_cuda_codes": max(
               float((g - w).abs().max()) for g, w in zip(grad_c, grad_rc)),
           "grad_excess_vs_ref_on_cuda_codes": _grad_excess(torch, grad_c,
                                                            grad_rc)}
    emit(out)
    check(len(gates["cuda"]) == len(gates["ref"]) == replay.i > 0,
          f"train_agreement/{arch}: gate calls {len(gates['cuda'])}, "
          f"{len(gates['ref'])}, {replay.i}")
    limit = AGREE_FLIP_SHARE * n_gate
    check(flips <= limit and same_inputs["flips"] <= limit,
          f"train_agreement/{arch}: {flips} gate outputs of {n_gate} differ "
          f"({same_inputs['flips']} on the same inputs)")
    check(max_step <= 1, f"train_agreement/{arch}: a gate output is "
          f"{max_step} levels from ref's on the same inputs")
    check(all(bool(torch.isfinite(g).all()) for g in grad_c),
          f"train_agreement/{arch}: non-finite gradient")
    check(out["grad_excess_vs_ref_on_cuda_codes"] <= 0.0,
          f"train_agreement/{arch}: gradients differ from ref on cuda's "
          f"codes beyond rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}")
    check(out["grad_excess_vs_ref"]
          <= (AGREE_FLIP_GRAD_EXCESS if flips else 0.0),
          f"train_agreement/{arch}: gradients differ from ref by "
          f"{out['grad_excess_vs_ref']} beyond rtol {TRAIN_RTOL}, atol "
          f"{TRAIN_ATOL} with {flips} flips")
    for other in (loss_r, loss_rc):
        check(abs(loss_c - other) <= TRAIN_ATOL + TRAIN_RTOL * abs(other),
              f"train_agreement/{arch}: losses {loss_c}, {loss_r}, "
              f"{loss_rc}")
    return out


def free_device(torch) -> None:
    """Return the memory of a finished phase to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 cases: list, main_case: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "call_ms": main_case["call_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "timed_by": main_case["timed_by"], **extra}


def agreement_seeds(torch, dev, seeds) -> int:
    """``--agreement-seeds``: only ``train_agreement``, both families, at
    each of ``seeds`` (the model's weights, tokens and ramp draws; the
    default run takes seed 4); every check as in the full run."""
    for seed in seeds:
        for arch in (TRAIN_LM["arch"], TRAIN_MOE["arch"]):
            phase_train_agreement(torch, dev, arch, seed)
            free_device(torch)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agreement-seeds", type=int, nargs="+", metavar="SEED",
                    help="run only train_agreement, at these seeds (one-off "
                         "readings of the gradient agreement)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import (_build, analog_tile, flash_decode,
                                     fused_matmul_nladc, launch_floor,
                                     lstm_cell, nladc, prefill_attention)
    from repro_torch.launch.common import configure_numerics

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flags = configure_numerics()
    if args.agreement_seeds:
        return agreement_seeds(torch, dev, args.agreement_seeds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_paths = _build.build_all(KERNELS)
    for mod in (lstm_cell, fused_matmul_nladc, prefill_attention, nladc,
                flash_decode, analog_tile, launch_floor):
        mod.library()
    lstm_cell.bwd_library()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in lib_paths.items():
        log = Path(str(path) + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and "registers" in ln]
        ptxas[name] = {"kernels": len(regs),
                       "max_registers": max(regs, default=None),
                       "spills": [ln.strip() for ln in lines
                                  if "spill" in ln and " 0 bytes spill "
                                  "stores, 0 bytes spill loads" not in ln]}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numerics": flags,
          "kernel_build_s": build_s, "ptxas": ptxas})

    checked = [phase_kernel(torch, dev, "ptb_flat", 16, 2016, 0),
               phase_kernel(torch, dev, "ptb_banked", 16, 2016, 512),
               phase_kernel(torch, dev, "ragged", 7, 32, 0)]

    runs = [phase_model(torch, dev, "ptb_lstm", bc, PTB_BATCHES, PTB_BATCH,
                        PTB_SEQ) for bc in (0, 512)]
    runs.append(phase_model(torch, dev, "kws_lstm", 0, KWS_BATCHES,
                            KWS_BATCH))
    bwd_checked = [
        phase_kernel_bwd(torch, dev, "ptb_flat", 16, 2016, 0),
        phase_kernel_bwd(torch, dev, "ptb_banked", 16, 2016, 512),
        phase_kernel_bwd(torch, dev, "kws", KWS_TRAIN_BATCH, 32, 0),
        phase_kernel_bwd(torch, dev, "ragged", 7, 32, 0)]
    trains = [phase_train(torch, dev, "ptb_lstm", bc) for bc in (0, 512)]
    trains.append(phase_train(torch, dev, "kws_lstm", 0))
    free_device(torch)

    irs = [phase_ir(torch, dev, preset, name, shape)
           for preset in IR_PRESETS for name, shape in IR_SHAPES]
    base = {(r["config"], r["bank_cols"]): r for r in runs}
    ir_runs = [phase_model(torch, dev, "ptb_lstm", bc, PTB_BATCHES,
                           PTB_BATCH, PTB_SEQ, analog_device=preset,
                           age_weights="tiled",
                           baseline=base[("ptb_lstm", bc)])
               for preset in IR_PRESETS for bc in (0, 512)]
    ir_runs += [phase_model(torch, dev, "kws_lstm", 0, KWS_BATCHES,
                            KWS_BATCH, analog_device=preset,
                            age_weights="tiled",
                            baseline=base[("kws_lstm", 0)])
                for preset in IR_PRESETS]
    trains.append(phase_train(torch, dev, "kws_lstm", 0,
                              analog_device="paper-ir"))
    free_device(torch)
    phase_fig4d(torch, dev)
    free_device(torch)

    bf16, f32 = torch.bfloat16, torch.float32
    fm_checked = [
        phase_fused_matmul(torch, dev, "decode_flat", 4, 2048, 11008, bf16, 0),
        phase_fused_matmul(torch, dev, "decode_banked", 4, 2048, 11008, bf16,
                           512),
        phase_fused_matmul(torch, dev, "prefill_flat", 1, 2048, 11008, bf16,
                           0),
        phase_fused_matmul(torch, dev, "prefill_banked", 1, 2048, 11008,
                           bf16, 512),
        phase_fused_matmul(torch, dev, "ragged_f32", 33, 300, 1000, f32, 0,
                           bias=True)]
    # the training shapes, timed after every earlier case: the profiler
    # loses events once a process has run a few dozen sessions, so the
    # earlier cases keep their place in the order
    train_checked = [
        phase_fused_matmul(torch, dev, "train_flat", 1024, 2048, 11008, bf16,
                           0, reps=5, inner=3),
        phase_fused_matmul(torch, dev, "train_banked", 1024, 2048, 11008,
                           bf16, 512, reps=5, inner=3),
        phase_moe_matmul(torch, dev, "train_fill", 64, 96, 2048, 1408, bf16,
                         0),
        phase_nladc(torch, dev, "router_train_bf16", (1024, 64), "sigmoid",
                    bf16, 0)]
    attn_checked = [
        phase_attention(torch, dev, "serve_bf16", bf16, SERVE["max_len"]),
        phase_attention(torch, dev, "serve_f32", f32, SERVE["max_len"]),
        phase_attention(torch, dev, "s2048_bf16", bf16, 2048)]

    nladc_checked = [
        phase_nladc(torch, dev, "router_bf16", (4, 64), "sigmoid", bf16, 0),
        phase_nladc(torch, dev, "mlp_banked_bf16", (4, 11008), "silu", bf16,
                    512),
        phase_nladc(torch, dev, "ragged_f32", (33, 1000), "tanh", f32, 0)]
    moe_checked = [
        phase_moe_matmul(torch, dev, "gate_flat", 64, 6, 2048, 1408, bf16, 0),
        phase_moe_matmul(torch, dev, "gate_banked", 64, 6, 2048, 1408, bf16,
                         512),
        phase_moe_matmul(torch, dev, "serving_fill", 64, 6, 2048, 1408, bf16,
                         0, fill="serving"),
        phase_moe_matmul(torch, dev, "none_live", 64, 6, 2048, 1408, bf16, 0,
                         fill="none"),
        phase_moe_matmul(torch, dev, "ragged_f32", 5, 7, 300, 1000, f32, 0)]
    flash_checked = [
        phase_flash_decode(torch, dev, "serve", 4, 16, 16, 128, 128,
                           [128, 128, 128, 128], bf16),
        phase_flash_decode(torch, dev, "serve_growing", 4, 16, 16, 128, 128,
                           [1, 37, 100, 128], bf16),
        phase_flash_decode(torch, dev, "gqa", 4, 16, 2, 128, 128,
                           [128, 1, 37, 100], bf16),
        phase_flash_decode(torch, dev, "zero_length", 4, 16, 16, 128, 128,
                           [128, 0, 37, 100], bf16),
        phase_flash_decode(torch, dev, "ragged_f32", 3, 8, 8, 64, 200,
                           [200, 65, 1], f32)]
    tile_checked = [
        phase_analog_tile(torch, dev, "ptb_gates", 16, 632, 8064, bf16, 5,
                          True, "tanh"),
        phase_analog_tile(torch, dev, "sweep_f32", 128, 256, 256, f32, None,
                          False, "swish"),
        phase_analog_tile(torch, dev, "ragged_f32", 33, 300, 1000, f32, 3,
                          True, "selu")]
    free_device(torch)

    served = phase_serve(torch, dev)
    free_device(torch)
    phase_agreement(torch, dev)
    free_device(torch)
    served_moe = phase_serve_moe(torch, dev)
    free_device(torch)
    phase_agreement_moe(torch, dev)
    free_device(torch)
    layers = TRAIN_MOE["n_layers"]
    trained = [phase_train_lm(torch, dev, "train_lm", TRAIN_LM, {
        "fused_matmul_nladc": 2 * 36})]
    free_device(torch)
    trained.append(phase_train_lm(torch, dev, "train_lm_banked", TRAIN_LM, {
        "fused_matmul_nladc": 2 * 36}, bank_cols=512))
    free_device(torch)
    trained.append(phase_train_lm(torch, dev, "train_moe", TRAIN_MOE, {
        k: 2 * layers for k in ("fused_matmul_nladc", "nladc",
                                "moe_fused_matmul")}))
    free_device(torch)
    for arch in (TRAIN_LM["arch"], TRAIN_MOE["arch"]):
        phase_train_agreement(torch, dev, arch)
        free_device(torch)
    infer = phase_serve(torch, dev, "lm_infer", analog_mode="infer",
                        analog_device=LM_INFER_DEVICE, repeats=1)
    free_device(torch)
    phase_agreement(torch, dev, "lm_infer_agreement", analog_mode="infer",
                    analog_device=LM_INFER_DEVICE)
    free_device(torch)
    tuned = phase_kernel_tune(torch, dev)
    free_device(torch)

    floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3

    def timed(checked_cases):
        return [phase_kernel_time(*c, floor_ms=floor_ms)
                for c in checked_cases]

    cases = timed(checked)
    bwd_cases = timed(bwd_checked)
    fm_cases = timed(fm_checked)
    attn_cases = timed(attn_checked)
    nladc_cases = timed(nladc_checked)
    moe_cases = timed(moe_checked)
    flash_cases = timed(flash_checked)
    tile_cases = timed(tile_checked)
    train_cases = timed(train_checked)
    fm_cases += train_cases[:2]
    moe_cases.append(train_cases[2])
    nladc_cases.append(train_cases[3])
    for case, call in irs:
        phase_ir_time(torch, case, call)

    main_case = cases[0]
    lstm = kernel_entry(
        "lstm_gates", "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "src/repro/kernels/lstm_cell.py:51",
        sum(r["launches"] for r in runs + ir_runs)
        + sum(r["launches_fwd"] for r in trains), cases, main_case,
        launches_per_run={
            **{f"{r['config']}/{r['analog_device']}/bank_cols="
               f"{r['bank_cols']}": r["launches"] for r in runs + ir_runs},
            **{f"train {r['config']}/{r['analog_device']}/bank_cols="
               f"{r['bank_cols']}": r["launches_fwd"] for r in trains}},
        bitwise=all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                    for c in cases),
        shape={"B": main_case["B"], "H": main_case["H"],
               "P": main_case["P"], "layout": main_case["layout"]})
    fm_main = fm_cases[0]
    fm_paths = {"serve": served["launches"]["fused_matmul_nladc"],
                "serve_moe": served_moe["launches"]["fused_matmul_nladc"],
                "lm_infer": infer["launches"]["fused_matmul_nladc"],
                **{t["phase"]: t["launches"]["fused_matmul_nladc"]
                   for t in trained}}
    fused = kernel_entry(
        "fused_matmul_nladc",
        "src/repro_torch/kernels/csrc/fused_matmul_nladc.cu",
        "src/repro/kernels/fused_matmul_nladc.py:59",
        sum(fm_paths.values()), fm_cases, fm_main,
        launches_per_path=fm_paths,
        code_flips=sum(c["code_flips"] for c in fm_cases),
        shape={k: fm_main[k] for k in ("M", "K", "N", "P", "x_dtype",
                                       "layout")},
        per_case={c["case"]: {k: c[k] for k in (
            "M", "layout", "route", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_f32_ms", "code_flips")} for c in fm_cases})
    at_main = attn_cases[0]
    attention = kernel_entry(
        "prefill_attention",
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:51",
        served["launches"]["prefill_attention"]
        + infer["launches"]["prefill_attention"], attn_cases, at_main,
        launches_per_path={
            "serve": served["launches"]["prefill_attention"],
            "lm_infer": infer["launches"]["prefill_attention"]},
        shape={k: at_main[k] for k in ("B", "H", "Hkv", "D", "S", "dtype",
                                       "cluster")},
        per_case={c["case"]: {k: c[k] for k in (
            "S", "cluster", "ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err", "max_bf16_ulps")} for c in attn_cases})
    nl_main = nladc_cases[0]
    moe_train = trained[-1]["launches"]
    nl = kernel_entry(
        "nladc", "src/repro_torch/kernels/csrc/nladc.cu",
        "src/repro/kernels/nladc_kernel.py:56",
        served_moe["launches"]["nladc"] + moe_train["nladc"], nladc_cases,
        nl_main, launches_per_path={"serve_moe": served_moe["launches"][
            "nladc"], "train_moe": moe_train["nladc"]},
        bitwise=all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                    for c in nladc_cases),
        shape={k: nl_main[k] for k in ("shape", "P", "x_dtype", "layout")},
        per_case={c["case"]: {k: c[k] for k in (
            "shape", "layout", "ms", "plain_ms", "bound_ms")}
            for c in nladc_cases})
    moe_main = moe_cases[0]
    moe = kernel_entry(
        "moe_fused_matmul",
        "src/repro_torch/kernels/csrc/fused_matmul_nladc.cu",
        "src/repro/kernels/ops.py:238",
        served_moe["launches"]["moe_fused_matmul"]
        + moe_train["moe_fused_matmul"], moe_cases, moe_main,
        launches_per_path={
            "serve_moe": served_moe["launches"]["moe_fused_matmul"],
            "train_moe": moe_train["moe_fused_matmul"]},
        code_flips=sum(c["code_flips"] for c in moe_cases),
        shape={k: moe_main[k] for k in ("E", "C", "K", "N", "P", "x_dtype",
                                        "layout", "blocks")},
        per_case={c["case"]: {k: c[k] for k in (
            "fill", "live_experts", "ms", "plain_ms", "library_ms",
            "bound_ms", "code_flips")} for c in moe_cases})
    fl_main = flash_cases[0]
    flash = kernel_entry(
        "flash_decode_int8",
        "src/repro_torch/kernels/csrc/flash_decode_int8.cu",
        "src/repro/kernels/flash_decode.py:76",
        served_moe["launches"]["flash_decode_int8"], flash_cases, fl_main,
        shape={k: fl_main[k] for k in ("B", "H", "Hkv", "D", "S",
                                       "q_dtype", "splits")},
        per_case={c["case"]: {k: c[k] for k in (
            "lengths", "splits", "ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err")} for c in flash_cases})
    tl_main = tile_cases[0]
    tile = kernel_entry(
        "analog_tile", "src/repro_torch/kernels/csrc/analog_tile.cu",
        "src/repro/kernels/crossbar_mac.py:60",
        tuned["launches"]["analog_tile"], tile_cases, tl_main,
        launches_per_path={"kernel_tune": tuned["launches"]["analog_tile"]},
        code_flips=sum(c["code_flips"] for c in tile_cases),
        shape={k: tl_main[k] for k in ("M", "K", "N", "P", "x_dtype",
                                       "input_bits", "noise", "ramp",
                                       "blocks")},
        per_case={c["case"]: {k: c[k] for k in (
            "M", "K", "N", "blocks", "ms", "plain_ms", "library_ms",
            "bound_ms", "code_flips")} for c in tile_cases})
    bwd_main = bwd_cases[0]
    lstm_bwd = kernel_entry(
        "lstm_gates_bwd", "src/repro_torch/kernels/csrc/lstm_cell_bwd.cu",
        "src/repro/core/backend.py:279",
        sum(r["launches_bwd"] for r in trains), bwd_cases, bwd_main,
        launches_per_run={f"train {r['config']}/{r['analog_device']}/"
                          f"bank_cols={r['bank_cols']}": r["launches_bwd"]
                          for r in trains},
        max_ulps=max(c["max_ulps"] for c in bwd_cases), ulp_bound=BWD_ULPS,
        code_mismatches=sum(c["code_mismatches"] for c in bwd_cases),
        shape={"B": bwd_main["B"], "H": bwd_main["H"], "P": bwd_main["P"],
               "layout": bwd_main["layout"]},
        per_case={c["case"]: {k: c[k] for k in (
            "B", "H", "layout", "ms", "plain_ms", "bound_ms", "max_ulps",
            "max_abs_err")} for c in bwd_cases})
    emit({"kernels": [lstm, fused, attention, nl, moe, flash, tile,
                      lstm_bwd]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
