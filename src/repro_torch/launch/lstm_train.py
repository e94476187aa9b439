"""Train the paper's analog LSTM hardware-aware (Alg. 1) on the GPU, then
evaluate it on the noisy chip.

The torch twin of ``train_eval_bpc`` in ``benchmarks/fig5c_ptb.py`` (PTB
char-LM: orthogonal char embeddings, per-step logits, mean NLL, Adam) and
of ``train_eval`` in ``benchmarks/fig4d_kws.py`` (KWS: last-step logits,
batches of a per-epoch permutation).  Training runs in ``mode="train"`` on
the device model's ``TrainNoise`` (the ``paper`` preset: 5 µS on the
weights and on the ramp steps, drawn every step); evaluation runs the
trained weights in ``mode="infer"`` on the same preset through
:func:`repro_torch.launch.lstm_eval.evaluate`.  Under ``--analog-device
paper-ir`` the IR correction of every crossbar and the I-V transform of
its inputs are in the graph, so the gradient flows through them, at
any width: autograd keeps only each correction's input and the backward
recomputes the correction (``torch.utils.checkpoint`` in
:func:`repro_torch.core.analog_layer._noisy_weights`).

    python -m repro_torch.launch.lstm_train --config ptb_lstm|kws_lstm \\
        [--device cuda|cpu] [--backend cuda|ref] [--analog-device paper] \\
        [--bits 5] [--bank-cols N] [--steps N] [--batch N] [--seq N] \\
        [--lr 2e-3] [--seed 0] [--eval-batches N] [--save PATH.npz] \\
        [--profile] [--kernel-cache kernel_tune.json] [--kernel-blocks SPEC]
    python -m repro_torch.launch.lstm_train --fig5c quick|full \\
        [--hidden 256 --proj 64] [--device cuda|cpu] [--backend cuda|ref]

Widths are the config's published ones (PTB 128 -> LSTM 2016, projection
504 -> 50; KWS 40 -> 32 -> 12).  Defaults follow the benchmarks' quick
modes: PTB B 16, T 128, 80 steps, lr 2e-3; KWS B 64 over fig4d's 768
training samples, 48 steps (4 epochs), lr 3e-3.  Data is the port's
synthetic ``CharCorpus`` / ``SyntheticKWS``.  Each step prints its loss,
its gradient's global norm, its milliseconds (host clock, ending on a device synchronize) and the
launches of the tail's forward and backward kernels; the end prints BPC
or accuracy.  ``--save`` writes the trained tree with
:func:`repro_torch.convert.save_npz` (``lstm_eval --params`` reads it).
``--profile`` adds one profiled train step: device busy and idle share
and the kernels by device time.  ``--fig5c`` runs
``benchmarks/fig5c_ptb.py``'s experiment instead (:func:`fig5c`: float,
then 5-, 4- and 3-bit NL-ADCs trained with Alg. 1 and evaluated with read
noise; BPC per row, each row's training losses, the benchmark's ordering
check printed, not gated), at the benchmark's widths unless ``--hidden``
and ``--proj`` say otherwise; it refuses the flags of a single run
(``--config``, ``--steps``, ...), and ``--hidden`` / ``--proj`` need it.  ``--kernel-cache`` and ``--kernel-blocks``
choose the kernels' launch configs (:mod:`repro_torch.kernels.tune`).

It runs on ``cuda`` unless ``--device cpu`` is given, and raises on a host
without a GPU otherwise; TF32 is off (``launch.common.configure_numerics``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import save_npz
from repro_torch.core.analog_layer import AnalogConfig
from repro_torch.core.crossbar import GeneratorNoise, NoiseSource
from repro_torch.data.pipeline import CharCorpus, SyntheticKWS
from repro_torch.kernels import lstm_cell
from repro_torch.launch import lstm_eval
from repro_torch.launch.common import (add_kernel_flags, configure_kernels,
                                      configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.nn.lstm import LSTMClassifier, LSTMSpec
from repro_torch.train import optim

CONFIGS = lstm_eval.CONFIGS
# the benchmarks' quick modes: (batch, steps, lr)
DEFAULTS = {"ptb_lstm": (16, 80, 2e-3), "kws_lstm": (64, 48, 3e-3)}
KWS_EVAL_SPLIT = lstm_eval.KWS_SPLITS[1]
FIG5C_BATCH, FIG5C_EVAL_BATCHES = 16, 4     # benchmarks/fig5c_ptb.py's
FIG5C_WIDTHS = (256, 64)                    # its (hidden, proj)
# the flags of one training run, which --fig5c's own runs do not read
TRAIN_ONLY_FLAGS = ("config", "analog_device", "bits", "bank_cols", "steps",
                    "batch", "seq", "lr", "seed", "eval_batches", "save",
                    "profile")

Batch = Tuple[torch.Tensor, torch.Tensor]


def analog_config(mode: str, *, bits: int = 5, analog_device: str = "paper",
                  bank_cols: int = 0, backend: str = "",
                  enabled: bool = True) -> AnalogConfig:
    """The benchmarks' analog config: ``bits`` for the ADC and the PWM
    inputs, on the named device-model preset."""
    return AnalogConfig(enabled=enabled, adc_bits=bits, input_bits=bits,
                        mode=mode, backend=backend, device=analog_device,
                        bank_cols=bank_cols)


def build_model(config: str, analog: AnalogConfig, device: torch.device, *,
                params=None, seed: int = 0) -> LSTMClassifier:
    """The config's classifier at its published widths; weights from
    ``params`` or drawn from ``seed``.

    Every mode builds on every preset.  Trained under a line stage (PTB on
    ``paper-ir``: 16 crossbar tiles of ``w_gates``, 4 of ``w_proj``), the
    IR correction is recomputed in the backward, so autograd holds one
    copy of each noisy weight a time step, not the correction's
    intermediates (``core/analog_layer.py::_noisy_weights``)."""
    cfg = configs.get(config)
    spec = LSTMSpec(n_in=cfg.n_input_features, n_hidden=cfg.lstm_hidden,
                    n_proj=cfg.lstm_proj, analog=analog)
    if params is not None:
        model = LSTMClassifier(spec, cfg.n_classes, params=params,
                               device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model = LSTMClassifier(spec, cfg.n_classes, generator=gen,
                               device=device)
    return model


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (both benchmarks' loss)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def loss_and_grads(model: LSTMClassifier, xs, labels, *,
                   noise: Optional[NoiseSource], all_steps: bool):
    """The loss and its gradient tree (the classifier's layout)."""
    tree = model.params()
    leaves = optim.tree_leaves(tree)
    loss = nll(model(xs, noise=noise, all_steps=all_steps), labels)
    grads = iter(torch.autograd.grad(loss, leaves))
    order = {id(p): next(grads) for p in leaves}
    return loss.detach(), optim.tree_map(lambda p: order[id(p)], tree)


def train_step(model: LSTMClassifier, opt: optim.Adam,
               state: optim.OptState, xs, labels, *,
               noise: Optional[NoiseSource], all_steps: bool):
    """One Alg. 1 step: the loss's gradient through the straight-through
    estimators, then one Adam update of the model's weights in place.
    Returns ``(new state, loss, the gradient's global norm)``, the norm as
    the reference's train steps report it (``grad_norm``)."""
    loss, grads = loss_and_grads(model, xs, labels, noise=noise,
                                 all_steps=all_steps)
    tree = model.params()
    with torch.no_grad():
        grad_norm = optim.global_norm(grads)
        new, state = opt.update(grads, state,
                                optim.tree_map(torch.Tensor.detach, tree))
        optim.tree_map(lambda p, q: p.copy_(q), tree, new)
    return state, loss, grad_norm


def ptb_train_batches(batch: int, seq: int,
                      device: torch.device) -> Iterator[Batch]:
    """fig5c's training stream: batch i is ``corpus.batch_at(i)``."""
    corpus = CharCorpus(seq_len=seq, batch=batch,
                        corpus_len=lstm_eval.PTB_CORPUS_LEN)
    emb = torch.from_numpy(corpus.embeddings()).to(device)
    i = 0
    while True:
        b = corpus.batch_at(i)
        toks = torch.from_numpy(b["tokens"].astype(np.int64)).to(device)
        labels = torch.from_numpy(b["labels"].astype(np.int64)).to(device)
        yield emb[toks], labels
        i += 1


def kws_train_batches(batch: int, device: torch.device, *,
                      data=None) -> Iterator[Batch]:
    """fig4d's training stream: epoch e visits the training split (``data``,
    else fig4d's quick-mode splits) in the order
    ``default_rng(e).permutation``, in whole batches."""
    if data is None:
        data = SyntheticKWS(seed=0).splits(*lstm_eval.KWS_SPLITS)
    (xtr, ytr), _ = data
    n = len(xtr)
    if batch > n:
        raise ValueError(f"batch {batch} exceeds the {n}-sample KWS "
                         f"training split")
    ep = 0
    while True:
        perm = np.random.default_rng(ep).permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            yield (torch.from_numpy(xtr[idx]).to(device),
                   torch.from_numpy(ytr[idx].astype(np.int64)).to(device))
        ep += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: LSTMClassifier, batches: Iterator[Batch], steps: int, *,
          lr: float, seed: int = 0, all_steps: bool, log=None) -> dict:
    """``steps`` Adam steps; the noise comes from a generator seeded by
    ``seed + 1`` on the model's device.  Returns the losses, the
    gradients' global norms, the ms of every step and the tail kernels'
    launches per step."""
    device = model.w_gates.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    noise = GeneratorNoise(gen)
    opt = optim.Adam(lr=lr)
    state = opt.init(optim.tree_map(torch.Tensor.detach, model.params()))
    losses, norms, step_ms, fwd, bwd = [], [], [], [], []
    for i in range(steps):
        xs, labels = next(batches)
        f0, b0 = lstm_cell.lstm_gates.launches, \
            lstm_cell.lstm_gates_bwd.launches
        _sync(device)
        t0 = time.perf_counter()
        state, loss, grad_norm = train_step(model, opt, state, xs, labels,
                                            noise=noise, all_steps=all_steps)
        loss = float(loss)              # the step's end on the host
        _sync(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        norms.append(float(grad_norm))
        fwd.append(lstm_cell.lstm_gates.launches - f0)
        bwd.append(lstm_cell.lstm_gates_bwd.launches - b0)
        if log is not None:
            log(f"[lstm_train] step {i} loss {loss:.6f} grad_norm "
                f"{norms[-1]:.6g} ms {step_ms[-1]:.2f} fwd_launches {fwd[-1]} "
                f"bwd_launches {bwd[-1]}")
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "fwd_launches": fwd, "bwd_launches": bwd}


def evaluate_trained(model: LSTMClassifier, config: str, *,
                     eval_batches: int, batch: int, seq: int,
                     seed: int = 0) -> dict:
    """The trained weights in infer mode on the training run's device
    preset, bank layout and backend (``lstm_eval.evaluate``)."""
    device = model.w_gates.device
    analog = model.spec.analog.replace(mode="infer")
    emodel = build_model(config, analog, device, params=model.params())
    all_steps = config == "ptb_lstm"
    if all_steps:
        data = lstm_eval.ptb_batches(eval_batches, batch, seq, device)
    else:
        data = lstm_eval.kws_batches(eval_batches, batch, device)
    res = lstm_eval.evaluate(emodel, data, all_steps=all_steps, seed=seed)
    return {"nll": res["nll"], "bpc": res["nll"] / math.log(2.0),
            "accuracy": res["accuracy"], "eval_step_ms": res["step_ms"]}


def train_eval_kws(train_cfg: AnalogConfig, eval_cfg: AnalogConfig, data,
                   device: torch.device, *, epochs: int, lr: float = 3e-3,
                   seed: int = 0, batch: int = 64, n_chips: int = 3) -> dict:
    """fig4d's ``train_eval``: train KWS for ``epochs`` on ``data``'s
    training split, then the test split's accuracy in ``eval_cfg`` over
    ``n_chips`` read-noise seeds (100, 101, ...): mean and spread."""
    model = build_model("kws_lstm", train_cfg, device, seed=seed)
    n = len(data[0][0])
    res = train(model, kws_train_batches(batch, device, data=data),
                epochs * (n // batch), lr=lr, seed=seed, all_steps=False)
    emodel = build_model("kws_lstm", eval_cfg, device,
                         params=model.params())
    xte, yte = data[1]
    test = [(torch.from_numpy(xte).to(device),
             torch.from_numpy(yte.astype(np.int64)).to(device))]
    accs = [lstm_eval.evaluate(emodel, test, all_steps=False,
                               seed=100 + chip)["accuracy"]
            for chip in range(n_chips)]
    return {"accuracy": float(np.mean(accs)), "spread": float(np.std(accs)),
            "train_steps": len(res["losses"]),
            "final_loss": res["losses"][-1]}


def fig4d(device: torch.device, *, backend: str = "", quick: bool = True,
          n_chips: int = 3) -> dict:
    """fig4d's ``run``: a float baseline, then 5-, 4- and 3-bit NL-ADCs
    trained with Alg. 1 noise and evaluated with read noise on the
    ``paper`` preset.  Returns the accuracies and whether
    float >= 5b >= 4b >= 3b held."""
    n_train, epochs = (768, 4) if quick else (3072, 12)
    data = SyntheticKWS(seed=0).splits(n_train, KWS_EVAL_SPLIT)
    rows = {}
    exact = analog_config("exact", enabled=False, analog_device="ideal",
                          backend=backend)
    rows["float"] = train_eval_kws(exact, exact, data, device, epochs=epochs,
                                   n_chips=n_chips)
    for bits in (5, 4, 3):
        rows[f"{bits}b"] = train_eval_kws(
            analog_config("train", bits=bits, backend=backend),
            analog_config("infer", bits=bits, backend=backend), data,
            device, epochs=epochs, n_chips=n_chips)
    acc = [rows[k]["accuracy"] for k in ("float", "5b", "4b", "3b")]
    return {"rows": rows, "n_train": n_train, "epochs": epochs,
            "ordering_held": all(a >= b for a, b in zip(acc, acc[1:]))}


def train_eval_bpc(train_cfg: AnalogConfig, eval_cfg: AnalogConfig,
                   device: torch.device, *, hidden: int, proj: int,
                   steps: int, seq: int, lr: float = 2e-3, seed: int = 0,
                   params=None) -> dict:
    """fig5c's ``train_eval_bpc``: a char-LM (128 -> LSTM ``hidden`` with
    projection ``proj`` -> 50) trained ``steps`` Adam steps in
    ``train_cfg`` on ``CharCorpus`` batches 0, 1, ... of 16 sequences,
    then evaluated in ``eval_cfg`` on batches 10,000 + i (i < 4), batch
    i's read noise from a generator seeded 500 + i; BPC = mean NLL / ln 2.
    Weights from a copy of ``params`` (a ``classifier_init`` tree, which
    training leaves as it was) or drawn from ``seed``.  Returns the BPC
    and the training losses."""
    cfg = configs.get("ptb_lstm")
    spec = LSTMSpec(n_in=cfg.n_input_features, n_hidden=hidden,
                    n_proj=proj, analog=train_cfg)
    n_classes = cfg.n_classes
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model = LSTMClassifier(spec, n_classes, generator=gen, device=device)
    else:
        # the model's parameters share their tensors' storage, and Adam
        # updates them in place
        model = LSTMClassifier(spec, n_classes, device=device,
                               params=optim.tree_map(torch.clone, params))
    res = train(model, ptb_train_batches(FIG5C_BATCH, seq, device), steps,
                lr=lr, seed=seed, all_steps=True)
    emodel = LSTMClassifier(dataclasses.replace(spec, analog=eval_cfg),
                            n_classes, params=model.params(), device=device)
    data = lstm_eval.ptb_batches(FIG5C_EVAL_BATCHES, FIG5C_BATCH, seq,
                                 device)
    with torch.no_grad():
        nlls = [lstm_eval.evaluate(emodel, [b], all_steps=True,
                                   seed=500 + i)["nll"]
                for i, b in enumerate(data)]
    return {"bpc": float(np.mean(nlls)) / math.log(2.0),
            "losses": res["losses"], "step_ms": res["step_ms"]}


def fig5c(device: torch.device, *, backend: str = "", quick: bool = True,
          hidden: int = FIG5C_WIDTHS[0], proj: int = FIG5C_WIDTHS[1],
          params=None, log=None) -> dict:
    """fig5c's ``run``: the float char-LM, then 5-, 4- and 3-bit NL-ADCs
    trained with Alg. 1 noise and evaluated with read noise on the
    ``paper`` preset; 80 steps at T 64 (quick) or 400 at T 128, B 16, lr
    2e-3, every row from the same starting weights (``params`` or seed
    0).  Returns the BPCs, each row's training losses, and the
    benchmark's own check, float <= 5b + 0.05 and 5b <= 3b + 0.05."""
    steps, seq = (80, 64) if quick else (400, 128)
    t0 = time.perf_counter()
    exact = analog_config("exact", enabled=False, backend=backend)
    cfgs = {"float": (exact, exact)}
    for bits in (5, 4, 3):
        cfgs[f"{bits}b"] = (analog_config("train", bits=bits,
                                          backend=backend),
                            analog_config("infer", bits=bits,
                                          backend=backend))
    rows, curves, step_ms = {}, {}, {}
    for name, (tcfg, ecfg) in cfgs.items():
        res = train_eval_bpc(tcfg, ecfg, device, hidden=hidden, proj=proj,
                             steps=steps, seq=seq, params=params)
        rows[name], curves[name] = res["bpc"], res["losses"]
        step_ms[name] = statistics.median(res["step_ms"])
        if log is not None:
            log(f"[fig5c] {name} BPC {res['bpc']:.4f} (median "
                f"{step_ms[name]:.1f} ms a train step)")
    held = rows["float"] <= rows["5b"] + 0.05 \
        and rows["5b"] <= rows["3b"] + 0.05
    return {"rows": rows, "losses": curves, "step_ms": step_ms,
            "steps": steps, "seq": seq, "hidden": hidden, "proj": proj,
            "ordering_held": held, "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ptb_lstm", choices=CONFIGS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("cuda", "ref"),
                    help="default: cuda on the GPU, ref on the CPU")
    ap.add_argument("--analog-device", default="paper",
                    help="device-model preset for training and evaluation")
    ap.add_argument("--bits", type=int, default=5,
                    help="ADC and PWM input bits")
    ap.add_argument("--bank-cols", type=int, default=0,
                    help="columns per threshold bank (0 = one shared ramp)")
    ap.add_argument("--steps", type=int, default=None,
                    help="Adam steps (default: PTB 80, KWS 48)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: PTB 16, KWS 64")
    ap.add_argument("--seq", type=int, default=128,
                    help="PTB sequence length (KWS is 49 frames)")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: PTB 2e-3, KWS 3e-3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--save", default=None,
                    help="write the trained tree here (.npz)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (GPU only)")
    ap.add_argument("--fig5c", choices=("quick", "full"), default=None,
                    help="run benchmarks/fig5c_ptb.py's experiment instead "
                         "(float, then 5-, 4- and 3-bit BPC)")
    ap.add_argument("--hidden", type=int, default=None,
                    help="--fig5c: LSTM width (default: the benchmark's 256)")
    ap.add_argument("--proj", type=int, default=None,
                    help="--fig5c: projection width (default: the "
                         "benchmark's 64)")
    add_kernel_flags(ap)
    args = ap.parse_args(argv)
    configure_kernels(ap, args)
    if args.fig5c:
        own = [f"--{k.replace('_', '-')}" for k in TRAIN_ONLY_FLAGS
               if getattr(args, k) != ap.get_default(k)]
        if own:
            ap.error(f"--fig5c fixes its own runs; it takes no "
                     f"{', '.join(own)}")
    elif args.hidden is not None or args.proj is not None:
        ap.error("--hidden and --proj size --fig5c's model; give --fig5c")

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile measures the GPU; it needs --device cuda")
    backend = args.backend or ("cuda" if device.type == "cuda" else "ref")
    flags = configure_numerics()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if args.fig5c:
        hidden = args.hidden or FIG5C_WIDTHS[0]
        proj = args.proj or FIG5C_WIDTHS[1]
        print(f"[fig5c] {args.fig5c} on {name}, backend {backend}, hidden "
              f"{hidden}, projection {proj}; TF32 off ({flags})",
              flush=True)
        out = fig5c(device, backend=backend, quick=args.fig5c == "quick",
                    hidden=hidden, proj=proj,
                    log=lambda s: print(s, flush=True))
        out.update(device=name, backend=backend)
        print(json.dumps(out), flush=True)
        return out
    batch0, steps0, lr0 = DEFAULTS[args.config]
    batch = args.batch or batch0
    steps = steps0 if args.steps is None else args.steps
    lr = args.lr or lr0
    analog = analog_config("train", bits=args.bits,
                           analog_device=args.analog_device,
                           bank_cols=args.bank_cols, backend=backend)
    model = build_model(args.config, analog, device, seed=args.seed)
    print(f"[lstm_train] {args.config} on {name}, backend {backend}, device "
          f"model {analog.device.name}, {args.bits} bits, bank_cols "
          f"{args.bank_cols}, B {batch}, {steps} steps, lr {lr}; TF32 off "
          f"({flags})", flush=True)
    all_steps = args.config == "ptb_lstm"
    if all_steps:
        batches = ptb_train_batches(batch, args.seq, device)
    else:
        batches = kws_train_batches(batch, device)
    res = train(model, batches, steps, lr=lr, seed=args.seed,
                all_steps=all_steps,
                log=lambda s: print(s, flush=True))
    out = {"config": args.config, "device": name, "backend": backend,
           "analog_device": analog.device.name, "bits": args.bits,
           "bank_cols": args.bank_cols, "B": batch, "steps": steps,
           "losses": res["losses"], "grad_norms": res["grad_norms"],
           "fwd_launches": res["fwd_launches"],
           "bwd_launches": res["bwd_launches"],
           "step_ms": statistics.median(res["step_ms"]) if steps else None,
           "step_ms_min": min(res["step_ms"], default=None),
           "step_ms_max": max(res["step_ms"], default=None)}
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if args.eval_batches:
        eval_batch = min(batch, KWS_EVAL_SPLIT // args.eval_batches) \
            if not all_steps else batch
        out.update(evaluate_trained(model, args.config,
                                    eval_batches=args.eval_batches,
                                    batch=eval_batch, seq=args.seq,
                                    seed=args.seed))
    if args.save:
        save_npz(args.save, optim.tree_map(
            lambda p: p.detach().cpu().numpy(), model.params()))
        out["saved"] = args.save
    print(json.dumps(out), flush=True)
    if args.profile:
        xs, labels = next(batches)
        opt = optim.Adam(lr=lr)
        state = opt.init(optim.tree_map(torch.Tensor.detach, model.params()))
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 2)
        # enough kernels that the tail's two show beside the GEMMs
        _, prof = device_profile(lambda: train_step(
            model, opt, state, xs, labels, noise=GeneratorNoise(gen),
            all_steps=all_steps), top=40)
        out["profile"] = prof
        print(json.dumps({"profile": prof}), flush=True)
    return out


if __name__ == "__main__":
    main()
