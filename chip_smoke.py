#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the build of the three kernels from
              ``kernels/csrc`` (one nvcc each, started together).
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
5. fused_matmul — the ``fused_matmul_nladc`` kernel against its plain
              version at the serving path's shapes (4 and 1 rows, K 2048,
              N 11008, bfloat16 x, float32 w) with one (P,) ramp and with
              512-column threshold banks, and a ragged float32 case.  Codes
              equal except where the float64 accumulator lies within the
              float32 summation bound of a crossed threshold (the count of
              such flips is printed); outputs equal the table at the
              kernel's codes.
6. attention — the ``prefill_attention`` kernel against its plain version
              at (B 4, H 16, Hkv 2, D 128, S 128), bfloat16 and float32,
              ragged masks: max abs diff 1e-6 in float32, one bfloat16 ulp.
7. serve    — qwen2.5-3b at full width and all 36 layers, bfloat16
              compute, ``cuda`` backend, seeded weights: 4 requests,
              max_batch 4, max_len 128, max_new 16.  Every request gets its
              16 tokens, every step's logits are finite, and each kernel
              launches 36 x (prefill steps + decode steps) times.  Tokens/s
              and ms per decode step: median of repeated runs, with spread.
8. agreement — a 2-layer, full-width, float32 variant decoded on the
              ``cuda`` and ``ref`` backends on the card: max |delta logits|
              < LSB/2 of the silu ramp.
9. kernel_time — device time per call of each kernel, of its plain
              version and of the PyTorch call used as a yardstick
              (torch.profiler), after the main paths.
10. kernels — one line listing every ported kernel with its launches on
              the main path, its error against the plain version and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises.  Without a GPU, or without the repository's ``src/repro_torch``
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
KERNELS = ("lstm_cell", "fused_matmul_nladc", "prefill_attention")
MAX_FLIP_SHARE = 0.01      # fused matmul: explained code flips, at most
ATTN_F32_ATOL = 1e-6
SERVE = dict(arch="qwen2.5-3b", requests=4, max_batch=4, max_len=128,
             max_new=16, repeats=5)
AGREE_LAYERS, AGREE_STEPS = 2, 8


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


def device_ms(fn, *, calls: int = 50) -> float:
    """Device time per call under ``torch.profiler``: the summed device
    time of every kernel ``fn`` launched, over ``calls`` calls (ms).  Host
    time between launches is not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler recorded no device time")
    return us / calls / 1e3


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


def phase_kernel_time(case: dict, kernel, plain, library=None) -> dict:
    """Device time per call (torch.profiler) of a kernel, its plain version
    and, where there is one, the PyTorch call used as a yardstick.  Run
    after the main paths: once the profiler has attached in a process,
    host launches there are slower, which would skew the step times."""
    out = {"phase": "kernel_time", "case": case["case"],
           "ms": device_ms(kernel), "plain_ms": device_ms(plain, calls=10),
           "library_ms": device_ms(library) if library else None,
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    emit(out)
    case.update(ms=out["ms"], plain_ms=out["plain_ms"],
                library_ms=out["library_ms"])
    return case


def phase_model(torch, dev, config: str, bank_cols: int, n_batches: int,
                batch: int, seq: int = 0):
    """One main-path run on the cuda backend, checked against ref."""
    import dataclasses

    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import lstm_eval
    from repro_torch.nn.lstm import LSTMClassifier

    model = lstm_eval.build_model(config, dev, backend="cuda",
                                  analog_device="paper-infer",
                                  bank_cols=bank_cols, seed=0)
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
    lstm_cell.lstm_gates.launches = 0
    res = lstm_eval.evaluate(model, data, all_steps=all_steps, seed=1)
    launches = lstm_cell.lstm_gates.launches
    check(launches == n_steps,
          f"{config}/bank_cols={bank_cols}: lstm_gates launched {launches} "
          f"times, expected {n_steps}")
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
          f"{config}/bank_cols={bank_cols}: logits differ from the ref "
          f"backend by {diff} > {LOGIT_ATOL}")
    out = {"phase": config.split("_")[0], "config": config,
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
           "ref_step_ms": res_ref["step_ms"]}
    emit(out)
    return out


def matmul_bound(m: int, k: int, n: int, p: int, banked: bool,
                 x_bytes: int, bias: bool) -> dict:
    """The least time the card needs for one fused_matmul_nladc call:
    x, w, bias, thresholds and table read once and the output written
    once, against the 2*M*K*N multiply-adds and the M*N*P compares at the
    float32 rate (the weight is float32, so no faster unit applies)."""
    n_bytes = (x_bytes * m * k + 4 * k * n + (4 * n if bias else 0)
               + 4 * (n * p if banked else p) + 4 * (p + 1)
               + x_bytes * m * n)
    n_ops = 2 * m * k * n + m * n * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_fused_matmul(torch, dev, name: str, m: int, k: int, n: int,
                       x_dtype, bank_cols: int, bias: bool = False):
    """The fused matmul kernel against its plain version; the kernel's
    codes come from a second launch with the counting table y(n) = n."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import fused_matmul_nladc as fmn
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
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
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


def phase_attention(torch, dev, name: str, dtype):
    """The cached-attention kernel against its plain version at the serving
    path's shape, ragged masks (one row sees a single slot)."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa

    b, h, hkv, d, s_len = SERVE["max_batch"], 16, 2, 128, SERVE["max_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    lengths = torch.tensor([s_len, 1, 37, 100], device=dev)
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
           "max_abs_err": err, "max_bf16_ulps": ulps,
           "library_max_abs_diff": lib_diff,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **attention_bound(b, h, hkv, d, s_len, q.element_size())}
    emit(out)
    return out, kernel, plain, library


def phase_serve(torch, dev) -> dict:
    """qwen2.5-3b at full width and depth on the cuda backend."""
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE["arch"], backend="cuda")
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
    fmn.fused_matmul_nladc.launches = 0
    pa.prefill_attention.launches = 0
    stats = engine.run_offline(reqs)
    launches = {"fused_matmul_nladc": fmn.fused_matmul_nladc.launches,
                "prefill_attention": pa.prefill_attention.launches}
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    for kname, count in launches.items():
        check(count == cfg.n_layers * steps,
              f"serve: {kname} launched {count} times, expected "
              f"{cfg.n_layers} x {steps}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          "serve: non-finite logits")
    check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
          f"serve: token counts {[len(r.generated) for r in reqs]}")

    runs = [engine.run_offline(serve.make_requests(
        cfg, SERVE["requests"], SERVE["max_new"]))
        for _ in range(SERVE["repeats"])]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    out = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "dtype": cfg.dtype, "backend": "cuda", **{
               k: SERVE[k] for k in ("requests", "max_batch", "max_len",
                                     "max_new")},
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": cfg.n_layers * steps,
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


def phase_agreement(torch, dev) -> dict:
    """A 2-layer, full-width, float32 variant on the cuda and ref backends:
    the same weights and tokens, max |delta logits| < LSB/2."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(SERVE["arch"], backend=bk).replace(
            n_layers=AGREE_LAYERS, dtype="float32")
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
              "agreement: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"agreement: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    out = {"phase": "agreement", "n_layers": AGREE_LAYERS, "dtype": "float32",
           "B": b, "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2}
    emit(out)
    return out


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 cases: list, main_case: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "call_ms": main_case["call_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"), **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, fused_matmul_nladc, lstm_cell
    from repro_torch.kernels import prefill_attention
    from repro_torch.launch.common import configure_numerics

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flags = configure_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_paths = _build.build_all(KERNELS)
    for mod in (lstm_cell, fused_matmul_nladc, prefill_attention):
        mod.library()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in lib_paths.items():
        log = Path(str(path) + ".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "smem" in ln
                       or "spill" in ln] if log.exists() else []
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
    attn_checked = [phase_attention(torch, dev, "serve_bf16", bf16),
                    phase_attention(torch, dev, "serve_f32", f32)]

    served = phase_serve(torch, dev)
    torch.cuda.empty_cache()
    phase_agreement(torch, dev)

    cases = [phase_kernel_time(*c) for c in checked]
    fm_cases = [phase_kernel_time(*c) for c in fm_checked]
    attn_cases = [phase_kernel_time(*c) for c in attn_checked]

    main_case = cases[0]
    lstm = kernel_entry(
        "lstm_gates", "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "src/repro/kernels/lstm_cell.py:51",
        sum(r["launches"] for r in runs), cases, main_case,
        launches_per_run={f"{r['config']}/bank_cols={r['bank_cols']}":
                          r["launches"] for r in runs},
        bitwise=all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                    for c in cases),
        shape={"B": main_case["B"], "H": main_case["H"],
               "P": main_case["P"], "layout": main_case["layout"]})
    fm_main = fm_cases[0]
    fused = kernel_entry(
        "fused_matmul_nladc",
        "src/repro_torch/kernels/csrc/fused_matmul_nladc.cu",
        "src/repro/kernels/fused_matmul_nladc.py:59",
        served["launches"]["fused_matmul_nladc"], fm_cases, fm_main,
        code_flips=sum(c["code_flips"] for c in fm_cases),
        shape={k: fm_main[k] for k in ("M", "K", "N", "P", "x_dtype",
                                       "layout")})
    at_main = attn_cases[0]
    attention = kernel_entry(
        "prefill_attention",
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:51",
        served["launches"]["prefill_attention"], attn_cases, at_main,
        shape={k: at_main[k] for k in ("B", "H", "Hkv", "D", "S", "dtype")})
    emit({"kernels": [lstm, fused, attention]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
