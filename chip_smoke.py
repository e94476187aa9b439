#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the kernel build from ``kernels/csrc``.
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
5. kernel_time — device time per call of the kernel and of its plain
              version (torch.profiler), after the main path.
6. kernels  — one line listing every ported kernel with its launches on
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

PTB_BATCHES, PTB_BATCH, PTB_SEQ = 2, 16, 128
KWS_BATCHES, KWS_BATCH = 2, 16
TIMING_REPEATS = 4
LOGIT_ATOL = 1e-6   # cuda vs ref backend: the tails are bitwise equal, so
#                     any code flip would show as an LSB-sized jump


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


def phase_kernel_time(case: dict, kernel, plain) -> dict:
    """Device time per call (torch.profiler).  Run after the main path:
    once the profiler has attached in a process, host launches there are
    slower, which would skew the main path's step times."""
    out = {"phase": "kernel_time", "case": case["case"],
           "ms": device_ms(kernel), "plain_ms": device_ms(plain, calls=10),
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    emit(out)
    case.update(ms=out["ms"], plain_ms=out["plain_ms"])
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
    from repro_torch.kernels import _build, lstm_cell
    from repro_torch.launch import lstm_eval

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flags = lstm_eval.configure_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build("lstm_cell")
    lstm_cell.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             Path(str(lib_path) + ".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln] \
        if Path(str(lib_path) + ".log").exists() else []
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": flags,
          "kernel_build_s": build_s, "ptxas": ptxas})

    checked = [phase_kernel(torch, dev, "ptb_flat", 16, 2016, 0),
               phase_kernel(torch, dev, "ptb_banked", 16, 2016, 512),
               phase_kernel(torch, dev, "ragged", 7, 32, 0)]

    runs = [phase_model(torch, dev, "ptb_lstm", bc, PTB_BATCHES, PTB_BATCH,
                        PTB_SEQ) for bc in (0, 512)]
    runs.append(phase_model(torch, dev, "kws_lstm", 0, KWS_BATCHES,
                            KWS_BATCH))

    cases = [phase_kernel_time(*c) for c in checked]

    main_case = cases[0]
    emit({"kernels": [{
        "name": "lstm_gates", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:51",
        "launches": sum(r["launches"] for r in runs),
        "launches_per_run": {f"{r['config']}/bank_cols={r['bank_cols']}":
                             r["launches"] for r in runs},
        "bitwise": all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                       for c in cases),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "shape": {"B": main_case["B"], "H": main_case["H"],
                  "P": main_case["P"], "layout": main_case["layout"]},
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
