"""Two checkouts of the port, kernel by kernel, on one card: device and
host time per wrapper call of the cached attention, the expert gate, the
dense gate, the int8 flash decode, the crossbar tile, the LSTM tail and
the elementwise NL-ADC, a digest of each output, and the largest
difference between the two checkouts' outputs.

    python src/repro_torch/launch/kernel_ab.py --trees OLD NEW [--rounds 1]

OLD and NEW are checkout roots (each holding ``src/repro_torch``).  Each
round runs OLD, NEW, NEW, OLD, each in a process of its own that imports
``repro_torch`` from that checkout and builds its kernels there, so a
drift of the card or the host over the call weighs on both alike.  The
last line of standard output is one JSON object: per case and checkout,
every run's numbers and their medians, whether the checkouts' outputs are
bitwise equal, and the max |delta| between the first OLD and the first NEW
output (each run saves its outputs under NEW's ``build/kernel_ab/``).  It
needs a CUDA card; the file imports nothing of the port itself, so it can
drive an older checkout.

The cases, all from seeded inputs made on the card:

* ``attention``: ``prefill_attention`` at the qwen2.5-3b serving shape
  (B 4, H 16, Hkv 2, D 128, S 128) in bfloat16 and float32, and at S 2048
  in bfloat16; at recurrentgemma's local attention (H 16, Hkv 1, D 256)
  over its full window S 2048 in bfloat16 and float32 (the ring of V
  boxes); at granite-34b's MQA (H 48, Hkv 1, D 128, S 128: three chunks
  of 16 heads, which a checkout without chunks refuses) and qwen2.5-32b's
  G 5 (H 40, Hkv 8: one chunk); rows see S, S - 3, S / 2 and 1 slots;
* ``gate_all_live`` / ``gate_serving_fill``: ``moe_fused_matmul`` at the
  moonshot expert gate's shape (E 64, C 6, K 2048, N 1408, bfloat16 x,
  float32 w, 31 flat thresholds) with every expert live, and with 17
  experts live (1 to 6 rows each; the other rows are +-0);
* ``dense_gate`` / ``dense_gate_prefill`` / ``dense_gate_train``:
  ``fused_matmul_nladc`` at qwen2.5-3b's MLP gate, bfloat16 x, at a decode
  step's (4, 2048, 11008) and a prefill step's M 1 (the GEMV, M <= 8) and
  at the training shape M = B x S = 1024 (the tensor-core GEMM);
* ``attention_ds_*`` / ``dense_gate_shared``: deepseek-moe-16b's cached
  attention (H 16 over Hkv 16, D 128, S 128) in bfloat16 and float32, and
  its shared experts' gate (4, 2048, 2816), bfloat16 x; their inputs are
  drawn after every other case's, so the earlier cases keep theirs;
* ``flash_serve`` / ``flash_gqa`` / ``flash_mqa48``: ``flash_decode_int8``
  at ``chip_smoke.py``'s shapes, bfloat16 q: moonshot's serving shape (B
  4, H = Hkv = 16, D 128, S 128, full rows), a GQA case (Hkv 2, lengths
  128, 1, 37, 100) and granite-34b's H 48 over Hkv 1 (six chunks of 8);
* ``tile_ptb``: ``analog_tile`` at the PTB gate crossbar (16, 632, 8064),
  bfloat16 x, 5-bit PWM, read noise, the tanh ramp;
* ``lstm_ptb_flat`` / ``lstm_ptb_banked`` / ``lstm_kws``: ``lstm_gates``
  at PTB's (B 16, H 2016) with the ``paper-infer`` 5-bit sigmoid and tanh
  ramps as one (P,) ramp each and as (H, P) banks of 512 columns, and at
  KWS's (16, 32); the inputs of ``chip_smoke.py``'s ``kernel`` phase (row
  0 of the f and a gates exactly on thresholds, c 0 there);
* ``nladc_router_bf16`` / ``nladc_mlp_banked_bf16`` / ``nladc_ragged_f32``:
  ``nladc`` at the MoE router's (4, 64) bfloat16 with the sigmoid ramp, at
  (4, 11008) bfloat16 with silu banks of 512 columns, and at a ragged
  (33, 1000) float32 with the tanh ramp; the inputs of ``chip_smoke.py``'s
  ``nladc`` phase (the first P values exactly on thresholds).

Host µs per call: ``HOST_CALLS`` calls issued back to back with no sync
inside the timing, over their count (the median of ``HOST_REPEATS``
runs), taken before any profiler session.  Device µs per call: the
profiler's kernel time (``tune.device_us``, the clock ``chip_smoke.py``
reports).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOST_CALLS, HOST_REPEATS = 200, 5
DEVICE_CALLS = 50
KERNELS = ("fused_matmul_nladc", "prefill_attention", "flash_decode_int8",
           "analog_tile", "lstm_cell", "nladc")


def _outputs(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


def _digest(res) -> str:
    import torch

    h = hashlib.sha256()
    for t in _outputs(res):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _lstm_case(torch, dev, b, h, bank_cols):
    """``lstm_gates`` on ``chip_smoke.py``'s ``kernel`` inputs."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import lstm_cell

    cfg = AnalogConfig(enabled=True, adc_bits=5, mode="infer",
                       device="paper-infer", bank_cols=bank_cols)
    sig = AnalogActivation("sigmoid", cfg, dev)
    tnh = AnalogActivation("tanh", cfg, dev)
    st, tt = sig.thresholds_for(h), tnh.thresholds_for(h)
    banked = not isinstance(st, torch.Tensor)
    if banked:
        st, tt = st.per_column, tt.per_column
    p = st.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 10_000 + h)
    gates = 2.0 * torch.randn((b, 4 * h), generator=gen, device=dev)
    c = 1.5 * torch.randn((b, h), generator=gen, device=dev)
    cols = torch.arange(h, device=dev)
    k = cols % p
    gates[0, cols] = st[cols, k] if banked else st[k]
    gates[0, h + cols] = tt[cols, k] if banked else tt[k]
    c[0] = 0.0
    args = (gates, c, st, sig.adc.y_table, tt, tnh.adc.y_table)
    return lambda: lstm_cell.lstm_gates(*args)


def _nladc_case(torch, dev, shape, act_name, x_dtype, bank_cols):
    """``nladc`` on ``chip_smoke.py``'s ``nladc`` inputs."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import nladc as nk

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="exact", device="ideal", bank_cols=bank_cols)
    act = AnalogActivation(act_name, cfg, dev)
    thr = act.thresholds_for(shape[-1])
    if not isinstance(thr, torch.Tensor):
        thr = thr.per_column
    p = thr.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(shape))
    x = 2.5 * torch.randn(shape, generator=gen, device=dev)
    x.view(-1)[:p] = thr.reshape(-1, p)[0]
    x = x.to(x_dtype)
    y_table = act.adc.y_table
    return lambda: nk.nladc(x, thr, y_table)


def _cases(torch, dev):
    """name -> a call of one wrapper on seeded inputs."""
    from repro_torch.core.nladc import build_ramp
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels.ref import closed_form_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for tag, dtype, s_len, (h, hkv, d) in (
            ("", bf16, 128, (16, 2, 128)), ("", f32, 128, (16, 2, 128)),
            ("", bf16, 2048, (16, 2, 128)),
            ("local_", bf16, 2048, (16, 1, 256)),
            ("local_", f32, 2048, (16, 1, 256)),
            ("mqa48_", bf16, 128, (48, 1, 128)),
            ("g5_", bf16, 128, (40, 8, 128))):
        q = randn(4, h, d).to(dtype)
        k = randn(4, s_len, hkv, d).to(dtype)
        v = randn(4, s_len, hkv, d).to(dtype)
        seen = torch.tensor([s_len, s_len - 3, s_len // 2, 1], device=dev)
        mask = (torch.arange(s_len, device=dev)[None] < seen[:, None]).int()
        name = f"attention_{tag}{str(dtype)[6:]}_s{s_len}"
        cases[name] = (lambda q=q, k=k, v=v, m=mask:
                       pa.prefill_attention(q, k, v, m))

    for name, h, hkv, lengths in (
            ("flash_serve", 16, 16, [128, 128, 128, 128]),
            ("flash_gqa", 16, 2, [128, 1, 37, 100]),
            ("flash_mqa48", 48, 1, [128, 1, 37, 100])):
        q = randn(4, h, 128).bfloat16()
        k8, v8 = (torch.randint(-127, 128, (4, 128, hkv, 128), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = ((1e-3 + 2e-2 * torch.rand((4, 128, hkv), generator=gen,
                                            device=dev)).bfloat16()
                  for _ in range(2))
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        cases[name] = (lambda a=(q, k8, ks, v8, vs, length):
                       fd.flash_decode_int8(*a))

    ramp = build_ramp("tanh", 5)
    dec = closed_form_params(ramp)
    tthr = torch.tensor(ramp.thresholds, dtype=torch.float32, device=dev)
    xt = (0.6 * randn(16, 632)).bfloat16()
    wt = (2.0 / math.sqrt(632)) * randn(632, 8064)
    nt = 0.02 * randn(632, 8064)
    cases["tile_ptb"] = lambda: at.analog_tile(xt, wt, tthr, dec, w_noise=nt,
                                               input_bits=5)

    e, c, k_dim, n = 64, 6, 2048, 1408
    w = randn(e, k_dim, n) / math.sqrt(k_dim)
    thr = torch.linspace(-2.0, 2.0, 31, device=dev)
    y_table = torch.linspace(-1.0, 1.0, 32, device=dev)
    x_all = randn(e, c, k_dim).bfloat16()
    live = torch.randperm(e, generator=gen, device=dev)[:17]
    rows = torch.randint(1, c + 1, (17,), generator=gen, device=dev)
    keep = torch.zeros((e, c), dtype=torch.bool, device=dev)
    keep[live] = torch.arange(c, device=dev)[None] < rows[:, None]
    # the dispatch buffer's empty rows are x * 0: +-0
    x_fill = torch.where(keep[..., None], x_all, x_all * 0)
    cases["gate_all_live"] = lambda: fmn.moe_fused_matmul(x_all, w, thr,
                                                          y_table)
    cases["gate_serving_fill"] = lambda: fmn.moe_fused_matmul(x_fill, w, thr,
                                                              y_table)

    xd = randn(4, 2048).bfloat16()
    wd = randn(2048, 11008) / math.sqrt(2048)
    xs = {"dense_gate": xd, "dense_gate_prefill": randn(1, 2048).bfloat16(),
          "dense_gate_train": randn(1024, 2048).bfloat16()}
    for name, x in xs.items():
        cases[name] = (lambda x=x: fmn.fused_matmul_nladc(x, wd, None, thr,
                                                          y_table))

    for name, b, h, bank_cols in (("lstm_ptb_flat", 16, 2016, 0),
                                  ("lstm_ptb_banked", 16, 2016, 512),
                                  ("lstm_kws", 16, 32, 0)):
        cases[name] = _lstm_case(torch, dev, b, h, bank_cols)
    for name, shape, act, dtype, bank_cols in (
            ("nladc_router_bf16", (4, 64), "sigmoid", bf16, 0),
            ("nladc_mlp_banked_bf16", (4, 11008), "silu", bf16, 512),
            ("nladc_ragged_f32", (33, 1000), "tanh", f32, 0)):
        cases[name] = _nladc_case(torch, dev, shape, act, dtype, bank_cols)
    # deepseek-moe-16b's shapes, drawn after every earlier case's inputs
    for dtype in (bf16, f32):
        q = randn(4, 16, 128).to(dtype)
        k, v = (randn(4, 128, 16, 128).to(dtype) for _ in range(2))
        seen = torch.tensor([128, 125, 64, 1], device=dev)
        mask = (torch.arange(128, device=dev)[None] < seen[:, None]).int()
        cases[f"attention_ds_{str(dtype)[6:]}_s128"] = (
            lambda q=q, k=k, v=v, m=mask: pa.prefill_attention(q, k, v, m))
    xs, ws = randn(4, 2048).bfloat16(), randn(2048, 2816) / math.sqrt(2048)
    cases["dense_gate_shared"] = lambda: fmn.fused_matmul_nladc(
        xs, ws, None, thr, y_table)
    return cases


def child(src: str, save: str) -> dict:
    """One checkout's numbers, in this process (run as a file, so
    ``sys.path[0]`` is this file's folder: ``src`` takes its place); its
    outputs go to the file ``save``."""
    sys.path[0] = src
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import tune

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    cases = _cases(torch, dev)
    out = {"src": src, "build_s": build_s, "cases": {}}
    outputs = {}
    for name, fn in list(cases.items()):
        try:
            res = fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as err:   # a shape it refuses
            out["cases"][name] = {"error": str(err)}
            del cases[name]
            continue
        runs = []
        for _ in range(HOST_REPEATS):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            runs.append((time.perf_counter() - t) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        outputs[name] = tuple(t.cpu() for t in _outputs(res))
        out["cases"][name] = {"digest": _digest(res),
                              "host_us": statistics.median(runs),
                              "host_us_runs": runs}
    for name, fn in cases.items():    # the profiler last: it slows the host
        us, clock = tune.device_us(fn, calls=DEVICE_CALLS)
        out["cases"][name].update(device_us=us, timed_by=clock)
    torch.save(outputs, save)
    return out


def _max_abs_diff(old: str, new: str) -> dict:
    """name -> max |delta| between two runs' saved outputs (float32)."""
    import torch

    a, b = torch.load(old), torch.load(new)
    return {name: max(float((u.float() - v.float()).abs().max())
                      for u, v in zip(_outputs(a[name]), _outputs(b[name])))
            for name in a if name in b}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", nargs=2, metavar=("SRC", "SAVE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(*args.child)), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    old, new = (str(Path(t).resolve() / "src") for t in args.trees)
    saves = Path(args.trees[1]).resolve() / "build" / "kernel_ab"
    saves.mkdir(parents=True, exist_ok=True)
    card = _card()
    print(card, flush=True)
    runs = {"old": [], "new": []}
    for _ in range(args.rounds):
        for which in ("old", "new", "new", "old"):
            src = old if which == "old" else new
            save = saves / f"{which}{len(runs[which])}.pt"
            proc = subprocess.run(
                [sys.executable, __file__, "--child", src, str(save)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"kernel_ab: the run of {src} failed")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": which, **res}), flush=True)
            runs[which].append(res)
    delta = _max_abs_diff(str(saves / "old0.pt"), str(saves / "new0.pt"))
    summary = {}
    for name in runs["new"][0]["cases"]:
        cell = {}
        for which, rs in runs.items():
            got = [r["cases"][name] for r in rs]
            if any("error" in g for g in got):
                cell[which] = {"error": got[0].get("error")}
                continue
            cell[which] = {
                "device_us": [g["device_us"] for g in got],
                "host_us": [g["host_us"] for g in got],
                "device_us_median": statistics.median(
                    g["device_us"] for g in got),
                "host_us_median": statistics.median(
                    g["host_us"] for g in got),
                "timed_by": sorted({g["timed_by"] for g in got})}
        digests = {r["cases"][name].get("digest")
                   for rs in runs.values() for r in rs}
        cell["bitwise_equal"] = len(digests) == 1
        cell["max_abs_diff"] = delta.get(name)
        summary[name] = cell
    print(json.dumps({"card": card, "order": "old new new old",
                      "rounds": args.rounds, "cases": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
