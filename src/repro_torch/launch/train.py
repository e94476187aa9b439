"""Train an LM on the GPU: ``python -m repro_torch.launch.train --arch
qwen2.5-3b``.

The torch twin of the JAX package's ``repro.launch.train`` on one device:
the deterministic ``SyntheticLM`` pipeline, the train step of
``launch.steps`` (AdamW with weight decay 0.1, clip to global norm 1.0,
a cosine schedule; each layer recomputed in the backward as the config's
``remat_policy`` says: ``full``, ``dots`` or ``none``, the same bits) and
the ``Trainer`` loop (its retrying executor, its ``Obs`` metrics and
spans; every step's metrics kept in its history).  Weights are drawn on
the device from ``--seed``.

    python -m repro_torch.launch.train --arch qwen2.5-3b \\
        [--smoke] [--override key=value ...] [--steps 100] [--batch 8] \\
        [--seq 128] [--backend cuda|ref] [--analog-device PRESET] \\
        [--analog-mode exact|train|infer] [--bank-cols N] [--seed 0] \\
        [--kernel-cache kernel_tune.json] [--kernel-blocks SPEC] \\
        [--device cuda|cpu] [--profile] [--ckpt-dir DIR]

Every LM family of ``ARCHS`` trains: the dense and MoE ones (pixtral-12b
with the stub frontend's patch embeddings over its first ``n_patches``
positions, as the reference's launcher feeds them), whisper-base (the
stub frontend's ``enc_len`` audio frames into its encoder, drawn once
from seed 7 as the reference draws them from key 7; every gate of both
stacks shares one train-mode ramp draw, as the reference's one key gives
it, and no layer is recomputed, as the reference's encoder-decoder loss
ignores ``remat``), mamba2-370m
(SSD) and recurrentgemma-9b (RG-LRU and local attention; its params are
the reference's ``groups`` of (rec, rec, attn) and a ``tail``, and
``--override n_layers=5`` cuts it to one group and a 2-block tail, as the
reference's config cuts it).  ``--analog-mode train`` on the ``paper``
preset is Alg. 1's hardware-aware training: fresh ramp-step noise on
every call of the MLP's (and the experts') hidden NL-ADC and of the
recurrent cells' NL-ADCs (SSD's dt softplus and z-gate silu, RG-LRU's
sigmoid gates and ``W_g`` gelu), one draw per threshold shape for all the
NL-ADCs of a layer, a hybrid group or the tail, as the reference's key
tree gives them; straight-through gradients through the gate kernels.  Every step prints its loss, the gradient's global norm, its
milliseconds (host clock, ending when the metrics reach the host) and the
launches of each kernel; the end prints one JSON summary (tokens/s over
the steps after the first, the peak device memory).  ``--profile`` adds
one profiled train step: device busy and idle share and the kernels by
device time.  ``--ckpt-dir`` checkpoints the params and the optimizer
state there (every 200 steps and at the end, keep 3, the reference's
defaults) and resumes from the latest checkpoint it holds, in the JAX
package's layout.

It runs on ``cuda`` unless ``--device cpu`` is given, and raises on a host
without a GPU otherwise; on the GPU the backend defaults to ``cuda``, on
the CPU to ``ref``; TF32 is off (``launch.common.configure_numerics``).
``--override remat_policy=dots`` trains with the matrix products' outputs
kept for the backward.  Not ported, raising with its ``ROADMAP.md`` item:
``--production-mesh`` and ``--grad-comm`` other than ``gspmd``, and a
MoE's ``moe_impl=ep_shardmap`` (queue A item 6, distribution).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Optional

import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.common import (add_kernel_flags, configure_kernels,
                                      configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.launch.serve import ARCHS, KERNELS, make_config, \
    parse_overrides
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.nn.frontends import audio_frame_stub, vision_patch_stub
from repro_torch.nn.model import build
from repro_torch.train.loop import TrainState, Trainer, to_device_batch

GRAD_COMM_MODES = ("gspmd", "psum", "hierarchical", "int8")


def build_trainer(cfg, device: torch.device, *, steps: int, batch: int,
                  seq: int, seed: int = 0, log=print,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 200):
    """(model, trainer, state): seeded weights on ``device``, the
    reference's optimizer scheduled over ``steps``, and the pipeline;
    checkpoints under ``ckpt_dir`` when given."""
    model = build(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen)
    opt = make_optimizer(cfg, total_steps=steps)
    extra = {}
    # the stub frontend's patch embeddings or audio frames, the same every
    # step (the reference draws them from one fixed key, 7)
    fgen = torch.Generator(device=device)
    fgen.manual_seed(7)
    if cfg.modality == "vision":
        extra["patch_embeds"] = vision_patch_stub(fgen, batch,
                                                  cfg.n_patches, cfg.d_model)
    if cfg.modality == "audio":
        extra["frames"] = audio_frame_stub(fgen, batch, cfg.enc_len,
                                           cfg.d_model)

    def put_batch(b):
        return {**to_device_batch(b, device), **extra}

    trainer = Trainer(model, opt, make_train_step(model, opt),
                      SyntheticLM(cfg.vocab, seq, batch), put_batch=put_batch,
                      log=log, log_every=1, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every)
    return model, trainer, TrainState(params, opt.init(params))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(trainer: Trainer, state: TrainState, steps: int,
          device: torch.device) -> dict:
    """``steps`` train steps, the kernel launches of each counted."""
    launches = []

    def counted(*args):
        before = {k: fn.launches for k, fn in KERNELS.items()}
        out = step_fn(*args)
        launches.append({k: fn.launches - before[k]
                         for k, fn in KERNELS.items()})
        return out

    step_fn = trainer.train_step
    trainer.train_step = counted
    _sync(device)
    try:
        state = trainer.fit(state, steps)
    finally:
        trainer.train_step = step_fn
    _sync(device)
    return {"state": state, "launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced SMOKE variant")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. n_layers=4); "
                         "repeatable")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--backend", default=None, choices=("cuda", "ref"),
                    help="default: cuda on the GPU, ref on the CPU")
    ap.add_argument("--analog-device", default="",
                    help="device-model preset (default: the spec's)")
    ap.add_argument("--analog-mode", default="",
                    choices=("", "exact", "train", "infer"),
                    help="override the spec's mode ('train' for Alg. 1)")
    ap.add_argument("--bank-cols", type=int, default=0,
                    help="columns per threshold bank (0 = one shared ramp)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    add_kernel_flags(ap)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (GPU only)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from the latest "
                         "checkpoint found there")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--grad-comm", choices=GRAD_COMM_MODES, default="gspmd")
    args = ap.parse_args(argv)
    if args.production_mesh or args.grad_comm != "gspmd":
        raise NotImplementedError("--production-mesh and --grad-comm "
                                  "psum|hierarchical|int8: distribution is "
                                  "not ported yet; ROADMAP.md queue A item "
                                  "6 brings it")
    configure_kernels(ap, args)

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile measures the GPU; it needs --device cuda")
    backend = args.backend or ("cuda" if device.type == "cuda" else "ref")
    flags = configure_numerics()
    cfg = make_config(args.arch, smoke=args.smoke, backend=backend,
                      bank_cols=args.bank_cols, analog_mode=args.analog_mode,
                      analog_device=args.analog_device,
                      overrides=parse_overrides(args.override))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[train] {cfg.name} ({cfg.n_layers} layers) on {name}, backend "
          f"{backend}, analog mode {cfg.analog.mode} on "
          f"{cfg.analog.device or 'the default preset'}, bank_cols "
          f"{cfg.analog.bank_cols}, {cfg.dtype} compute, B {args.batch} x S "
          f"{args.seq}, {args.steps} steps; TF32 off ({flags})", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model, trainer, state = build_trainer(
        cfg, device, steps=args.steps, batch=args.batch, seq=args.seq,
        seed=args.seed, log=lambda s: print(s, flush=True),
        ckpt_dir=args.ckpt_dir)
    res = train(trainer, state, args.steps, device)
    hist = trainer.history
    later = trainer.step_ms[1:] or trainer.step_ms
    step_ms: Optional[float] = statistics.median(later) if later else None
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "device": name,
           "backend": backend, "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device, "B": args.batch,
           "S": args.seq, "steps": args.steps,
           "losses": [h["loss"] for h in hist],
           "aux_losses": [h.get("aux_loss", 0.0) for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms_all": trainer.step_ms, "step_ms": step_ms,
           "tokens_per_s": (args.batch * args.seq * 1e3 / step_ms
                            if step_ms else None),
           "launches": res["launches"], "ckpt_dir": args.ckpt_dir}
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(json.dumps(out), flush=True)
    if args.profile:
        state = res["state"]
        batch = trainer.put_batch(trainer.pipeline.batch_at(args.steps))
        _, prof = device_profile(lambda: trainer.train_step(
            state.params, state.opt_state, batch, args.steps), top=24)
        out["profile"] = prof
        print(json.dumps({"profile": prof}), flush=True)
    return out


if __name__ == "__main__":
    main()
