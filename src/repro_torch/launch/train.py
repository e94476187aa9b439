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
kept for the backward.

``--grad-comm psum|hierarchical|int8`` trains data-parallel with explicit
gradient collectives (``launch.steps.make_dp_train_step``; ``int8``
carries each rank's error-feedback residual in the optimizer state), one
process a rank:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
        --device cpu --batch 2 --seq 16 --steps 2 --grad-comm int8

or at world size 1 without ``torch.distributed.run``.  The backend is
NCCL on ``--device cuda`` (rank ``LOCAL_RANK``'s card) and gloo on
``--device cpu``.  ``ft.elastic.plan_for_devices(world, global_batch=
--batch, model_parallel=1)`` sizes the data axis to divide the batch;
ranks beyond it leave with a note.  Every rank draws the global batch
(``SyntheticLM.batch_at`` is pure in seed and step) and trains on its
rows; rank 0 prints.  ``--ckpt-dir`` and ``--profile`` take ``gspmd``
only.  ``--production-mesh`` (the 16x16 layout) is not ported: it raises,
naming the next slice (``launch/{mesh,specs,dryrun}.py``, ``ROADMAP.md``
queue A item 6), and with another ``--grad-comm`` it is a usage error,
as the reference's launcher makes it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.common import (add_kernel_flags, configure_kernels,
                                      configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.launch.serve import ARCHS, KERNELS, make_config, \
    parse_overrides
from repro_torch.dist.sharding import batch_specs, local_shard, mesh_coords
from repro_torch.ft.elastic import build_mesh, plan_for_devices
from repro_torch.launch.steps import (make_dp_opt_state, make_dp_train_step,
                                      make_optimizer, make_train_step)
from repro_torch.nn.frontends import audio_frame_stub, vision_patch_stub
from repro_torch.nn.model import build
from repro_torch.train import optim
from repro_torch.train.loop import TrainState, Trainer, to_device_batch

GRAD_COMM_MODES = ("gspmd", "psum", "hierarchical", "int8")


def build_trainer(cfg, device: torch.device, *, steps: int, batch: int,
                  seq: int, seed: int = 0, log=print,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 200,
                  mesh=None, grad_comm: str = "gspmd"):
    """(model, trainer, state): seeded weights on ``device``, the
    reference's optimizer scheduled over ``steps``, and the pipeline;
    checkpoints under ``ckpt_dir`` when given.  With a ``mesh`` and a
    ``grad_comm`` other than ``gspmd``, the data-parallel step on this
    rank's rows of every batch."""
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

    dp = grad_comm != "gspmd"
    coords = mesh_coords(mesh) if dp else None

    def put_batch(b):
        full = {**to_device_batch(b, device), **extra}
        if not dp:
            return full
        return local_shard(full, batch_specs(full, mesh), mesh, coords)

    step = make_dp_train_step(model, opt, mesh, grad_comm=grad_comm) \
        if dp else make_train_step(model, opt)
    trainer = Trainer(model, opt, step, SyntheticLM(cfg.vocab, seq, batch),
                      put_batch=put_batch, log=log, log_every=1,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    return model, trainer, TrainState(
        params, make_dp_opt_state(opt, params, grad_comm=grad_comm))


def init_distributed(device_name: str):
    """The default process group for ``--grad-comm``: ``(rank, world,
    device, cleanup)``.  Under ``torch.distributed.run`` its environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous); without
    it, world size 1 over a file store in a temporary directory.  NCCL on
    the rank's card, gloo on the CPU."""
    backend = "nccl" if device_name == "cuda" else "gloo"
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = resolve_device(device_name)
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, device_id=device
                                if device.type == "cuda" else None)
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)

    def cleanup():
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    return dist.get_rank(), dist.get_world_size(), device, cleanup


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
    dp = args.grad_comm != "gspmd"
    if args.production_mesh and dp:
        ap.error("--production-mesh requires --grad-comm gspmd: the "
                 "explicit-collective DP path builds its own data-parallel "
                 "(model=1) mesh and would silently drop the 16x16 layout")
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh (the 16x16 mesh and its layout) is not "
            "ported yet; the next slice of ROADMAP.md queue A item 6 brings "
            "it with launch/{mesh,specs,dryrun}.py")
    if dp and (args.ckpt_dir or args.profile):
        ap.error("--ckpt-dir and --profile take --grad-comm gspmd")
    configure_kernels(ap, args)
    if not dp:
        return _main(args, resolve_device(args.device))
    rank, world, device, cleanup = init_distributed(args.device)
    try:
        plan = plan_for_devices(world, global_batch=args.batch,
                                model_parallel=1)
        mesh = build_mesh(plan, "cuda" if device.type == "cuda" else "cpu")
        used = plan.new_shape["data"] * plan.new_shape["model"]
        if used < world and rank == 0:
            print(f"[train] note: data axis must divide --batch "
                  f"{args.batch}; using {used} of {world} devices",
                  flush=True)
        if rank >= used:
            return {}
        return _main(args, device, mesh=mesh, rank=rank, world=used)
    finally:
        cleanup()


def _main(args, device: torch.device, *, mesh=None, rank: int = 0,
          world: int = 1) -> dict:
    """Train as ``args`` say on ``device``; with a ``mesh``, this rank's
    part of the data-parallel run.  Returns the summary that rank 0
    prints, and the trained ``TrainState`` under ``state``."""
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
    say = (lambda s: print(s, flush=True)) if rank == 0 else None
    comm = "" if mesh is None else f", --grad-comm {args.grad_comm} over " \
        f"{world} ranks"
    if say:
        say(f"[train] {cfg.name} ({cfg.n_layers} layers) on {name}, "
            f"backend {backend}, analog mode {cfg.analog.mode} on "
            f"{cfg.analog.device or 'the default preset'}, bank_cols "
            f"{cfg.analog.bank_cols}, {cfg.dtype} compute, B {args.batch} x "
            f"S {args.seq}, {args.steps} steps{comm}; TF32 off ({flags})")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model, trainer, state = build_trainer(
        cfg, device, steps=args.steps, batch=args.batch, seq=args.seq,
        seed=args.seed, log=say, ckpt_dir=args.ckpt_dir, mesh=mesh,
        grad_comm=args.grad_comm)
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
           "launches": res["launches"], "ckpt_dir": args.ckpt_dir,
           "grad_comm": args.grad_comm, "world": world}
    if args.grad_comm == "int8":
        out["ef_norm"] = float(optim.global_norm(
            res["state"].opt_state["ef"]))
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if say:
        say(json.dumps(out))
    if args.profile:
        state = res["state"]
        batch = trainer.put_batch(trainer.pipeline.batch_at(args.steps))
        _, prof = device_profile(lambda: trainer.train_step(
            state.params, state.opt_state, batch, args.steps), top=24)
        out["profile"] = prof
        print(json.dumps({"profile": prof}), flush=True)
    out["state"] = res["state"]            # the trained params, not printed
    return out


if __name__ == "__main__":
    main()
