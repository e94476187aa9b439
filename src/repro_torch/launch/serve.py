"""Serve an LM on the GPU: ``python -m repro_torch.launch.serve --arch
qwen2.5-3b``, or a MoE LM with an int8 KV cache::

    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --override n_layers=24 --override kv_cache_dtype=int8

The torch twin of the JAX package's ``repro.launch.serve`` on its scan
prefill: builds the model at the config's published widths (or its SMOKE
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
on ramps programmed once at build time by the ``--analog-device`` preset
(the LM spec carries no weight noise, so a step draws nothing; the
reference's engine hands its steps keys that nothing reads); in train mode
the ramps are the ideal ones, as the reference's engine passes no key
there.  ``--kernel-cache`` (a
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
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import load_npz
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import fused_matmul_nladc as fmn
from repro_torch.kernels import nladc as nk
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels import tune
from repro_torch.launch.common import (configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.nn.model import build
from repro_torch.serve.engine import Request, ServingEngine

ARCHS = ("qwen2.5-3b", "moonshot-v1-16b-a3b", "deepseek-moe-16b")

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
    ap.add_argument("--kernel-cache", default="",
                    help="path to a kernel tune result JSON "
                         "(repro_torch.launch.kernel_tune output); launch "
                         "configs then resolve per shape from it (also: "
                         "REPRO_TORCH_KERNEL_CACHE env)")
    ap.add_argument("--kernel-blocks", default="",
                    help="force per-kernel launch configs, e.g. "
                         "'fused_matmul_nladc=4x64x512,nladc=8x32'; "
                         "overrides the tune cache (also: "
                         "REPRO_TORCH_KERNEL_BLOCKS env)")
    args = ap.parse_args(argv)
    try:
        tune.configure(args.kernel_blocks, args.kernel_cache)
    except (ValueError, OSError) as e:
        ap.error(f"--kernel-blocks/--kernel-cache: {e}")

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile measures the GPU; it needs --device cuda")
    backend = args.backend or ("cuda" if device.type == "cuda" else "ref")
    flags = configure_numerics()
    cfg = make_config(args.arch, smoke=args.smoke, backend=backend,
                      bank_cols=args.bank_cols, analog_mode=args.analog_mode,
                      analog_device=args.analog_device,
                      overrides=parse_overrides(args.override))
    model, params = build_lm(cfg, device, params_path=args.params,
                             seed=args.seed)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers, {cfg.kv_cache_dtype} "
          f"KV cache) on {name}, backend {backend}, {cfg.dtype} compute, "
          f"analog mode {cfg.analog.mode}, bank_cols "
          f"{cfg.analog.bank_cols}; TF32 and reduced-precision "
          f"bf16 sums off ({flags})", flush=True)
    engine = ServingEngine(model, params, max_batch=args.max_batch,
                           max_len=args.max_len)
    engine.run_offline(make_requests(cfg, 1, 2))              # warm-up
    launches0 = {k: fn.launches for k, fn in KERNELS.items()}
    stats = engine.run_offline(make_requests(cfg, args.requests,
                                             args.max_new))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "kv_cache_dtype": cfg.kv_cache_dtype, "device": name,
           "backend": backend, "requests": args.requests, **stats,
           "launches": {k: fn.launches - launches0[k]
                        for k, fn in KERNELS.items()}}
    print(json.dumps(out), flush=True)
    if args.profile:
        res, prof = device_profile(lambda: engine.run_offline(
            make_requests(cfg, args.requests, args.max_new)), top=16)
        out["profile"] = {"decode_steps": res["decode_steps"],
                          "prefill_steps": res["prefill_steps"], **prof}
        print(json.dumps({"profile": out["profile"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
