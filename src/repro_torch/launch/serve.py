"""Serve an LM on the GPU: ``python -m repro_torch.launch.serve --arch
qwen2.5-3b``, another dense LM (granite-3-8b, qwen2.5-32b, pixtral-12b
served on text, as the reference's engine serves it, and granite-34b,
whose 48 query heads share one KV head), the encoder-decoder whisper-base
(its decoder served on text with cross K/V of zeros, as the reference's
engine serves it, and deployed as the others are: an aging
``--analog-device``, the lifecycle, ``--ckpt-dir`` / ``--resume`` and
``--fleet``), a MoE LM (moonshot-v1-16b-a3b with an int8 KV cache,
deepseek-moe-16b's softmax router and shared experts), or a recurrent LM
(the SSD of mamba2-370m, the RG-LRU and local attention of
recurrentgemma-9b)::

    python -m repro_torch.launch.serve --arch granite-34b \
        --override n_layers=40 [--override kv_cache_dtype=int8]
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --override n_layers=24 --override kv_cache_dtype=int8
    python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --override n_layers=26
    python -m repro_torch.launch.serve --arch whisper-base \
        --analog-mode infer --analog-device aged-1day \
        --age-per-step-s 3600 --recal-every 8 --ckpt-dir DIR
    python -m repro_torch.launch.serve --arch mamba2-370m
    python -m repro_torch.launch.serve --arch recurrentgemma-9b

The torch twin of the JAX package's ``repro.launch.serve`` for one chip:
builds the model at the config's published widths (or its SMOKE
variant with ``--smoke``; ``--override key=value`` replaces config
fields, as the JAX ``repro.launch.dryrun --override`` does), submits a
wave of synthetic requests made as the JAX launcher makes them
(``np.random.default_rng(0)``, prompt lengths 4-11, tokens below
``cfg.vocab``), drains them through the
:class:`~repro_torch.serve.engine.ServingEngine`, and prints one JSON
summary line.  Weights come from ``--params`` (an LM tree saved by
:func:`repro_torch.convert.save_npz`) or are drawn from ``--seed``.

    python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        [--smoke] [--override key=value ...] [--requests 6] \\
        [--max-new 16] [--max-batch 4] [--max-len 128] \\
        [--backend cuda|ref] [--bank-cols N] \\
        [--analog-mode exact|infer|train] [--analog-device PRESET] \\
        [--device cuda|cpu] [--params lm.npz] [--seed 0] [--profile] \\
        [--prefill-buckets auto|N,N,...] [--pack-prefill] [--detok-thread] \\
        [--offline] [--ckpt-dir DIR] [--resume] \\
        [--age-per-step-s S --recal-every N --recal-inl-lsb X] \\
        [--drain-before-rejit] [--fleet N --capacity-floor F \\
        --router least-loaded --canary PRESET --force-drain-step N \\
        --shelf-age-per-step-s S] [--metrics-dir DIR] [--trace t.jsonl \\
        [--trace-wall-clock]] [--prom] \\
        [--kernel-cache kernel_tune.json] [--kernel-blocks SPEC]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises on a host
without a GPU otherwise; seeded weights are drawn on that device (a
host-side draw of moonshot's 14.8 B parameters at 24 layers would take
minutes).  On the GPU the backend defaults to ``cuda`` (the MLP gate,
every cached attention, and for a MoE the router's NL-ADC and the grouped
expert gate in the hand-written kernels), on the CPU to ``ref``.  A
one-request warm-up wave builds the kernels and initialises cuBLAS before
the measured run.  ``--profile`` serves the
wave once more under ``torch.profiler`` and prints the device time per
kernel name and the device's idle share.  ``--analog-mode infer`` serves
the chip the ``--analog-device`` preset programs: ramps programmed once at
build time, and weights aged per crossbar tile by the preset's build stage
(the engine's ``device=``, as the reference's launcher passes it; the LM
spec carries no weight noise, so a step draws nothing).  Outside infer
mode the preset is inert, and the launcher says so, as the reference's
does; in train mode the ramps are the ideal ones, as the reference's
engine passes no key there.

``--prefill-buckets`` serves the bucketed prefill (``auto``: powers of two
up to ``max_len - 1``), ``--pack-prefill`` packs each admission wave into
one call (it needs buckets), ``--detok-thread`` lands each step's tokens
on a background thread.  ``--offline`` runs the engine's ``warmup()``
(every bucket and one decode step on throwaway states) in place of the
warm-up wave.  ``--ckpt-dir`` checkpoints the deployment there at the end
(the step numbers grow across resumed runs); with ``--resume`` the engine
is restored from it instead of programming a fresh chip.

The lifecycle (infer mode): ``--age-per-step-s`` > 0 attaches a
:class:`~repro_torch.serve.lifecycle.RecalScheduler` (device seconds per
step, an INL probe every ``--recal-every`` steps, one-point
re-calibration past ``--recal-inl-lsb``); ``--drain-before-rejit`` defers
a re-program until the wave drained.  With a scheduler, or any of the
observability flags, the throwaway-state ``warmup()`` takes the warm-up
wave's place, so the measured run's lifecycle and metrics are its own.
``--fleet N`` serves N chips behind the
:class:`~repro_torch.serve.fleet.FleetEngine` router and planner
(``--capacity-floor``, ``--router``, ``--canary PRESET`` repeatable,
``--force-drain-step``, ``--shelf-age-per-step-s``).  Observability:
``--trace`` writes the span/event trace as JSONL (read it back with
``python -m repro_torch.obs.replay``), ``--trace-wall-clock`` adds host
times to it, ``--metrics-dir`` writes ``metrics.json`` and
``metrics.prom``, ``--prom`` prints the Prometheus text.  The summary's
``energy`` is ``core/hwcost.py``'s model of the analog chip, not a
measurement of the GPU.  ``--kernel-cache`` (a
``repro_torch.launch.kernel_tune`` result) and ``--kernel-blocks``
(``fused_matmul_nladc=4x64x512,nladc=8x32``) choose the kernels' launch
configs per shape (:mod:`repro_torch.kernels.tune`); a bad spec or file is
a usage error.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.ckpt.checkpoint import list_checkpoints
from repro_torch.convert import load_npz
from repro_torch.core.device import resolve_device as resolve_device_model
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import fused_matmul_nladc as fmn
from repro_torch.kernels import nladc as nk
from repro_torch.kernels import prefill_attention as pa
from repro_torch.launch.common import (add_kernel_flags, configure_kernels,
                                      configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.nn.model import build
from repro_torch.obs import Obs
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.fleet import ROUTERS, FleetEngine, FleetPolicy
from repro_torch.serve.lifecycle import RecalPolicy

ARCHS = ("qwen2.5-3b", "granite-3-8b", "qwen2.5-32b", "pixtral-12b",
         "whisper-base", "granite-34b", "moonshot-v1-16b-a3b",
         "deepseek-moe-16b", "mamba2-370m", "recurrentgemma-9b")

# the kernel wrappers whose launches the summary counts
KERNELS = {"fused_matmul_nladc": fmn.fused_matmul_nladc,
           "prefill_attention": pa.prefill_attention,
           "nladc": nk.nladc,
           "moe_fused_matmul": fmn.moe_fused_matmul,
           "flash_decode_int8": fd.flash_decode_int8}


def parse_overrides(items: Sequence[str]) -> Dict[str, object]:
    """``key=value`` strings into config fields, the value read as a
    Python literal where it is one (``n_layers=24``) and kept as a string
    otherwise (``kv_cache_dtype=int8``)."""
    overrides = {}
    for kv in items:
        if "=" not in kv:
            raise ValueError(f"--override wants key=value, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v
    return overrides


def make_config(arch: str, *, smoke: bool = False, backend: str = "",
                bank_cols: int = 0, analog_mode: str = "",
                analog_device: str = "", overrides=None) -> ModelConfig:
    """The arch's config (or SMOKE variant) with ``overrides`` applied and
    the CLI's analog knobs (an empty mode or device keeps the spec's)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    spec_kw = {"backend": backend, "bank_cols": bank_cols}
    if analog_mode:
        spec_kw["mode"] = analog_mode
    if analog_device:
        spec_kw["device"] = analog_device
    return cfg.replace(analog=dataclasses.replace(cfg.analog, **spec_kw))


def make_requests(cfg: ModelConfig, n: int, max_new: int) -> List[Request]:
    """The JAX launcher's synthetic requests, draw for draw."""
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        prompt = rng.integers(0, cfg.vocab,
                              size=rng.integers(4, 12)).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    return reqs


def build_lm(cfg: ModelConfig, device: torch.device, *,
             params_path: str = "", seed: int = 0):
    """(model, params): params from ``params_path``, else seeded."""
    model = build(cfg, device)
    if params_path:
        return model, load_npz(params_path, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return model, model.init(gen)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced SMOKE variant")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. n_layers=24, "
                         "kv_cache_dtype=int8); repeatable")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--backend", default=None, choices=("cuda", "ref"),
                    help="default: cuda on the GPU, ref on the CPU")
    ap.add_argument("--bank-cols", type=int, default=0,
                    help="columns per threshold bank (0 = one shared ramp)")
    ap.add_argument("--analog-mode", default="",
                    choices=("", "exact", "infer", "train"),
                    help="override the spec's mode")
    ap.add_argument("--analog-device", default="",
                    help="device-model preset (default: the spec's, i.e. "
                         "REPRO_DEVICE or paper)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--params", default="",
                    help=".npz LM tree (convert.save_npz)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (without --params)")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time per kernel (GPU only)")
    ap.add_argument("--prefill-buckets", default="",
                    help="the bucketed prefill: comma-separated bucket "
                         "lengths (e.g. '8,16,32') or 'auto' for powers "
                         "of two up to max_len-1; empty = the scan prefill")
    ap.add_argument("--pack-prefill", action="store_true",
                    help="pack each admission wave into one bucket call "
                         "(requires --prefill-buckets)")
    ap.add_argument("--detok-thread", action="store_true",
                    help="land each step's tokens on a background thread")
    ap.add_argument("--offline", action="store_true",
                    help="warmup() every bucket and the decode step, then "
                         "the measured run")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the deployment here at the end of the "
                         "run")
    ap.add_argument("--resume", action="store_true",
                    help="restore the deployment from --ckpt-dir instead "
                         "of programming a fresh chip")
    ap.add_argument("--age-per-step-s", type=float, default=0.0,
                    help="device seconds added per engine step; > 0 "
                         "attaches the re-calibration scheduler (infer "
                         "mode only)")
    ap.add_argument("--recal-every", type=int, default=64,
                    help="engine steps between INL probes")
    ap.add_argument("--recal-inl-lsb", type=float, default=1.0,
                    help="a ramp's deployed INL (LSB) above which it is "
                         "re-calibrated")
    ap.add_argument("--drain-before-rejit", action="store_true",
                    help="drain the in-flight wave before a chip "
                         "re-program instead of re-programming mid-wave")
    ap.add_argument("--shelf-age-per-step-s", type=float, default=0.0,
                    help="fleet: device seconds added per fleet step to "
                         "chips serving no traffic (0 disables)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve a fleet of N chips behind the router and "
                         "the maintenance planner; 0 = one chip")
    ap.add_argument("--capacity-floor", type=float, default=0.75,
                    help="fleet: share of chips that keep accepting "
                         "traffic; bounds concurrent drains")
    ap.add_argument("--router", default="least-loaded", choices=ROUTERS,
                    help="fleet admission policy")
    ap.add_argument("--canary", action="append", default=[],
                    help="fleet: pin one chip to this device preset as a "
                         "canary (repeatable)")
    ap.add_argument("--force-drain-step", type=int, default=0,
                    help="fleet: force a maintenance request on the first "
                         "chip at this step")
    ap.add_argument("--metrics-dir", default="",
                    help="write the metrics registry here at exit "
                         "(metrics.json + metrics.prom)")
    ap.add_argument("--trace", default="",
                    help="record the span/event trace and write it to "
                         "this JSONL path at exit (step clock: seeded runs "
                         "write the same bytes)")
    ap.add_argument("--trace-wall-clock", action="store_true",
                    help="add wall_s / wall_dur_s to the trace entries")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition at exit")
    add_kernel_flags(ap)
    args = ap.parse_args(argv)
    configure_kernels(ap, args)
    if args.pack_prefill and not args.prefill_buckets:
        ap.error("--pack-prefill requires --prefill-buckets")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    prefill_kw = {"detok_thread": args.detok_thread}
    if args.prefill_buckets:
        prefill_kw["prefill"] = "bucketed"
        prefill_kw["pack_prefill"] = args.pack_prefill
        if args.prefill_buckets != "auto":
            try:
                prefill_kw["prefill_buckets"] = tuple(
                    int(b) for b in args.prefill_buckets.split(","))
            except ValueError:
                ap.error("--prefill-buckets must be 'auto' or a "
                         "comma-separated list of ints")

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile measures the GPU; it needs --device cuda")
    backend = args.backend or ("cuda" if device.type == "cuda" else "ref")
    flags = configure_numerics()
    cfg = make_config(args.arch, smoke=args.smoke, backend=backend,
                      bank_cols=args.bank_cols, analog_mode=args.analog_mode,
                      analog_device=args.analog_device,
                      overrides=parse_overrides(args.override))
    if args.age_per_step_s > 0 and cfg.analog.mode != "infer":
        ap.error("--age-per-step-s requires --analog-mode infer (the "
                 "lifecycle acts on a deployed device model)")
    if args.canary and cfg.analog.mode != "infer":
        ap.error("--canary requires --analog-mode infer (canaries are "
                 "pinned to deployed device presets)")
    recal = None
    if args.age_per_step_s > 0:
        recal = RecalPolicy(age_per_step_s=args.age_per_step_s,
                            check_every=args.recal_every,
                            inl_threshold_lsb=args.recal_inl_lsb)
    obs = Obs(trace=bool(args.trace), wall_clock=args.trace_wall_clock)
    obs_on = bool(args.trace or args.metrics_dir or args.prom)
    if args.fleet:
        out = _serve_fleet(ap, args, cfg, device, recal, prefill_kw, obs)
        _export_obs(args, obs)
        return out
    model, params = build_lm(cfg, device, params_path=args.params,
                             seed=args.seed)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers, {cfg.kv_cache_dtype} "
          f"KV cache) on {name}, backend {backend}, {cfg.dtype} compute, "
          f"analog mode {cfg.analog.mode}, bank_cols "
          f"{cfg.analog.bank_cols}; TF32 and reduced-precision "
          f"bf16 sums off ({flags})", flush=True)
    # build-stage aging composes with infer mode only: exact mode would
    # pair aged weights with a pristine NL-ADC, a chip that cannot exist
    chip = None
    if cfg.analog.mode == "infer":
        chip = resolve_device_model(cfg.analog.device)
        if chip.has_build_stage and not args.resume:
            print(f"[serve] applying device model {chip.name!r} build "
                  "stage to params (write noise / faults / drift; "
                  "per-tile TilePlan-keyed draws)", flush=True)
    elif args.analog_device:
        print(f"[serve] note: --analog-device {args.analog_device} is inert "
              f"in analog mode {cfg.analog.mode!r}; pass --analog-mode infer "
              "for the deployment simulation", flush=True)
    if args.resume:
        engine = ServingEngine.restore(
            model, args.ckpt_dir, params_like=params,
            drain_before_rejit=args.drain_before_rejit, obs=obs,
            **prefill_kw)
        sched = engine.scheduler
        if recal is not None:
            if sched is None:
                ap.error("--age-per-step-s with --resume needs a checkpoint "
                         "that was serving with a scheduler (this one has "
                         "none, and re-programming its ramps would discard "
                         "the restored chip state)")
            # knob changes are safe on resume; the chip is not touched
            sched.policy = recal
        print(f"[serve] resumed deployment from {args.ckpt_dir}"
              + (f" (age {sched.age_s:.0f}s, {sched.n_recals} recals)"
                 if sched is not None else ""), flush=True)
    else:
        engine = ServingEngine(model, params, max_batch=args.max_batch,
                               max_len=args.max_len, device=chip,
                               recal=recal,
                               drain_before_rejit=args.drain_before_rejit,
                               obs=obs, **prefill_kw)
    del params
    if args.offline or engine.scheduler is not None or obs_on:
        w = engine.warmup()
        print(f"[serve] warmup: prefill buckets "
              f"{tuple(w['prefill_buckets'])} + decode step", flush=True)
    else:
        engine.run_offline(make_requests(cfg, 1, 2))          # warm-up
    launches0 = {k: fn.launches for k, fn in KERNELS.items()}
    stats = engine.run_offline(make_requests(cfg, args.requests,
                                             args.max_new))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "kv_cache_dtype": cfg.kv_cache_dtype, "device": name,
           "backend": backend, "requests": args.requests,
           "analog_mode": cfg.analog.mode,
           "aged": engine.device.name if engine.device is not None
           and engine.device.has_build_stage else None,
           "prefill": engine.prefill_mode, "pack_prefill":
           engine.pack_prefill, "detok_thread": args.detok_thread,
           "prefill_buckets": list(engine.prefill_buckets), **stats,
           "launches": {k: fn.launches - launches0[k]
                        for k, fn in KERNELS.items()}, "ckpt": None,
           "lifecycle": None}
    if engine.scheduler is not None:
        s = engine.scheduler
        out["lifecycle"] = {"age_s": s.age_s, "probes": len(s.events),
                            "recals": s.n_recals,
                            "weight_gen": engine._weight_gen}
        for ev in s.events:
            line = (f"  step {ev['step']:>5}  age {ev['age_s']:.0f}s  "
                    f"INL {ev['inl_lsb']:.3f} LSB")
            if ev["recalibrated"]:
                line += f" -> recal -> {ev['inl_after_lsb']:.3f} LSB"
            print(line, flush=True)
    if args.ckpt_dir:
        # steps grow across resumed runs, so the latest checkpoint is
        # always the newest deployment
        prev = list_checkpoints(args.ckpt_dir)
        out["ckpt"] = engine.save(args.ckpt_dir,
                                  step=(prev[-1] if prev else 0)
                                  + stats["tokens"])
    print(json.dumps(out), flush=True)
    _export_obs(args, obs)
    if args.profile:
        res, prof = device_profile(lambda: engine.run_offline(
            make_requests(cfg, args.requests, args.max_new)), top=16)
        out["profile"] = {"decode_steps": res["decode_steps"],
                          "prefill_steps": res["prefill_steps"], **prof}
        print(json.dumps({"profile": out["profile"]}), flush=True)
    return out


def _export_obs(args, obs) -> None:
    """Write the run's trace, metrics and Prometheus text per the flags."""
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        obs.tracer.write_jsonl(args.trace)
        print(f"[serve] trace: {len(obs.tracer.entries)} entries -> "
              f"{args.trace}", flush=True)
    if args.metrics_dir:
        os.makedirs(args.metrics_dir, exist_ok=True)
        jpath = os.path.join(args.metrics_dir, "metrics.json")
        with open(jpath, "w") as f:
            f.write(obs.metrics.dump_json())
        ppath = os.path.join(args.metrics_dir, "metrics.prom")
        with open(ppath, "w") as f:
            f.write(obs.metrics.to_prometheus())
        print(f"[serve] metrics -> {jpath} + {ppath}", flush=True)
    if args.prom:
        print(obs.metrics.to_prometheus(), end="", flush=True)


def _serve_fleet(ap, args, cfg, device, recal, prefill_kw, obs) -> dict:
    """``--fleet N``: N chips, the router, the planner, canaries, the
    fleet manifest.  Prints the events, each chip's health and energy
    (hwcost's model), and one JSON summary line."""
    policy = FleetPolicy(capacity_floor=args.capacity_floor,
                         router=args.router,
                         shelf_age_per_step_s=args.shelf_age_per_step_s)
    if args.resume:
        fleet = FleetEngine.restore(cfg, args.ckpt_dir, obs=obs,
                                    torch_device=device)
        print(f"[serve] resumed fleet of {len(fleet.chips)} chips from "
              f"{args.ckpt_dir} (step {fleet.step_count}, "
              f"{len(fleet.events)} events)", flush=True)
    else:
        fleet = FleetEngine.build(
            cfg, args.fleet, policy=policy, recal=recal,
            max_batch=args.max_batch, max_len=args.max_len,
            canary_presets=tuple(args.canary), obs=obs,
            torch_device=device, **prefill_kw)
        roles = ", ".join(
            f"{cid}{' (canary: ' + c.device.name + ')' if c.spec.canary else ''}"
            for cid, c in fleet.chips.items())
        print(f"[serve] fleet up: {roles}; router={policy.router} "
              f"capacity_floor={policy.capacity_floor} (max "
              f"{fleet.planner.max_drain} draining)", flush=True)
    fleet.warmup()
    for req in make_requests(cfg, args.requests, args.max_new):
        fleet.submit(req)
    t0 = time.perf_counter()
    n_tokens = 0
    min_accepting = len(fleet.chips)
    while any(c.engine.queue or not all(c.engine.slot_free)
              for c in fleet.chips.values()):
        if args.force_drain_step \
                and fleet.step_count + 1 == args.force_drain_step:
            fleet.force_maintenance(sorted(fleet.chips)[0])
        n_tokens += len(fleet.step())
        min_accepting = min(min_accepting, len(fleet.accepting()))
    n_tokens += sum(len(b) for c in fleet.chips.values()
                    for b in c.engine.detok_flush())
    dt = time.perf_counter() - t0
    lat = fleet.admission_latency_steps()
    for ev in fleet.events:
        extra = {k: v for k, v in ev.items() if k not in ("step", "type")}
        print(f"  step {ev['step']:>5}  {ev['type']}"
              + (f"  {extra}" if extra else ""), flush=True)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "chips":
           len(fleet.chips), "requests": args.requests,
           "tokens": int(n_tokens), "seconds": float(dt),
           "tokens_per_s": float(n_tokens / dt) if dt > 0 else 0.0,
           "admission_steps_p95": float(np.percentile(lat, 95))
           if lat else 0.0, "min_accepting": min_accepting,
           "events": len(fleet.events), "health": fleet.health(),
           "energy": fleet.energy_report(), "ckpt": None}
    if args.ckpt_dir:
        out["ckpt"] = fleet.save(args.ckpt_dir, fleet.step_count)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
