"""Evaluate the paper's analog LSTM (infer mode) on the GPU.

The torch twin of the evaluation in ``benchmarks/fig5c_ptb.py`` (PTB
char-LM: orthogonal char embeddings -> ``classifier_apply(all_steps=True)``
-> mean NLL, reported as bits per character) and of ``fig4d_kws.py``'s
test pass (KWS: last-step logits -> accuracy).  Weights come from
``--params`` (a classifier tree saved by :func:`repro_torch.convert.save_npz`)
or are drawn from ``--seed``.  ``--age-weights tiled`` ages them once per
crossbar tile with the device model's build stage
(``DeviceModel.age_params`` with no rng, the deployment path of the
reference's ``ServingEngine`` and ``device_sweep(tiled=True)``) before the
evaluation; every registered preset evaluates, the circuit-level
``paper-ir`` and ``stressed-ir`` included.

    python -m repro_torch.launch.lstm_eval --config ptb_lstm \\
        [--device cuda|cpu] [--backend cuda|ref] \\
        [--analog-device paper-infer] [--age-weights none|tiled] \\
        [--bank-cols N] [--batches 4] [--batch 16] [--seq 128]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises on a host
without a GPU otherwise.  TF32 is switched off for matmuls and cuDNN, so
every matmul is full float32 (``launch.common.configure_numerics``).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import load_npz
from repro_torch.core.analog_layer import AnalogConfig
from repro_torch.core.crossbar import GeneratorNoise
from repro_torch.data.pipeline import CharCorpus, SyntheticKWS
from repro_torch.kernels import lstm_cell
from repro_torch.launch.common import (configure_numerics, device_profile,
                                      resolve_device)
from repro_torch.nn.lstm import LSTMClassifier, LSTMSpec, classifier_init

CONFIGS = ("kws_lstm", "ptb_lstm")
AGING = ("none", "tiled")

# fig5c's corpus size and eval offset; fig4d's quick-mode split sizes
PTB_CORPUS_LEN = 60_000
PTB_EVAL_STEP0 = 10_000
KWS_SPLITS = (768, 384)

Batch = Tuple[torch.Tensor, torch.Tensor]


def build_model(config: str, device: torch.device, *, backend: str = "",
                analog_device: str = "", bank_cols: int = 0,
                params_path: Optional[str] = None, seed: int = 0,
                age_weights: str = "none") -> LSTMClassifier:
    """The config's classifier at its published widths, deployed on the
    analog device model (ramps programmed host-side, once; with
    ``age_weights="tiled"`` the weights aged per crossbar tile, once)."""
    if age_weights not in AGING:
        raise ValueError(f"age_weights must be one of {AGING}, got "
                         f"{age_weights!r}")
    cfg = configs.get(config)
    analog = AnalogConfig.from_spec(cfg.analog, device=analog_device,
                                    bank_cols=bank_cols).replace(
                                        backend=backend)
    spec = LSTMSpec(n_in=cfg.n_input_features, n_hidden=cfg.lstm_hidden,
                    n_proj=cfg.lstm_proj, analog=analog)
    if params_path:
        params = load_npz(params_path)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = classifier_init(gen, spec, cfg.n_classes)
    if age_weights == "tiled":
        params = analog.device.age_params(params)
    return LSTMClassifier(spec, cfg.n_classes, params=params, device=device)


def ptb_batches(n_batches: int, batch: int, seq: int,
                device: torch.device) -> List[Batch]:
    """fig5c's eval batches: embedded chars (B, T, 128) and next chars."""
    corpus = CharCorpus(seq_len=seq, batch=batch, corpus_len=PTB_CORPUS_LEN)
    emb = torch.from_numpy(corpus.embeddings()).to(device)
    out = []
    for i in range(n_batches):
        b = corpus.batch_at(PTB_EVAL_STEP0 + i)
        toks = torch.from_numpy(b["tokens"].astype(np.int64)).to(device)
        labels = torch.from_numpy(b["labels"].astype(np.int64)).to(device)
        out.append((emb[toks], labels))
    return out


def kws_batches(n_batches: int, batch: int,
                device: torch.device) -> List[Batch]:
    """fig4d's test split, cut into batches: MFCCs (B, 49, 40), labels."""
    _, (xte, yte) = SyntheticKWS(seed=0).splits(*KWS_SPLITS)
    if n_batches * batch > len(xte):
        raise ValueError(f"{n_batches} x {batch} exceeds the "
                         f"{len(xte)}-sample KWS test split")
    return [(torch.from_numpy(xte[i * batch:(i + 1) * batch]).to(device),
             torch.from_numpy(yte[i * batch:(i + 1) * batch].astype(
                 np.int64)).to(device))
            for i in range(n_batches)]


@torch.no_grad()
def evaluate(model: LSTMClassifier, data: List[Batch], *, all_steps: bool,
             seed: int = 0) -> dict:
    """Run every batch with read noise drawn from a generator seeded by
    ``seed``; the clock covers the model calls only, ending on a device
    synchronize."""
    device = data[0][0].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = GeneratorNoise(gen)
    logits = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for xs, _ in data:
        logits.append(model(xs, noise=noise, all_steps=all_steps))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    nll, correct, count = 0.0, 0, 0
    for lg, (_, y) in zip(logits, data):
        logp = torch.log_softmax(lg, dim=-1)
        nll += float(-logp.gather(-1, y[..., None]).mean())
        correct += int((lg.argmax(-1) == y).sum())
        count += y.numel()
    n_steps = len(data) * data[0][0].shape[1]
    n_tokens = len(data) * data[0][0].shape[0] * data[0][0].shape[1]
    return {"logits": logits, "nll": nll / len(data),
            "accuracy": correct / count, "seconds": seconds,
            "steps": n_steps, "step_ms": 1e3 * seconds / n_steps,
            "tokens_per_s": n_tokens / seconds}


def profile_device(model: LSTMClassifier, data: List[Batch], *,
                   all_steps: bool, seed: int = 0, top: int = 12) -> dict:
    """:func:`evaluate` under ``torch.profiler``
    (:func:`~repro_torch.launch.common.device_profile`)."""
    res, prof = device_profile(
        lambda: evaluate(model, data, all_steps=all_steps, seed=seed),
        top=top)
    return {"steps": res["steps"], **prof}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ptb_lstm", choices=CONFIGS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("cuda", "ref"),
                    help="default: cuda on the GPU, ref on the CPU")
    ap.add_argument("--analog-device", default="paper-infer",
                    help="device-model preset programmed onto the chip")
    ap.add_argument("--age-weights", default="none", choices=AGING,
                    help="age the weights per crossbar tile before the "
                         "evaluation (the device model's build stage)")
    ap.add_argument("--bank-cols", type=int, default=0,
                    help="columns per threshold bank (0 = one shared ramp)")
    ap.add_argument("--params", default=None,
                    help=".npz classifier tree (convert.save_npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128,
                    help="PTB sequence length (KWS is 49 frames)")
    ap.add_argument("--profile", action="store_true",
                    help="also print device time per kernel (GPU only)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise ValueError("--profile measures the GPU; it needs --device cuda")
    backend = args.backend or ("cuda" if device.type == "cuda" else "ref")
    flags = configure_numerics()
    model = build_model(args.config, device, backend=backend,
                        analog_device=args.analog_device,
                        bank_cols=args.bank_cols, params_path=args.params,
                        seed=args.seed, age_weights=args.age_weights)
    analog = model.spec.analog
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[lstm_eval] {args.config} on {name}, backend "
          f"{analog.backend}, device model {analog.device.name}, "
          f"weights aged: {args.age_weights}, bank_cols "
          f"{analog.bank_cols}; TF32 off ({flags})")
    if args.config == "ptb_lstm":
        data = ptb_batches(args.batches, args.batch, args.seq, device)
    else:
        data = kws_batches(args.batches, args.batch, device)
    all_steps = args.config == "ptb_lstm"
    # one warm-up batch builds the kernel and initialises cuBLAS off the clock
    evaluate(model, data[:1], all_steps=all_steps, seed=args.seed + 1)
    launches0 = lstm_cell.lstm_gates.launches
    res = evaluate(model, data, all_steps=all_steps, seed=args.seed)
    out = {"config": args.config, "device": name,
           "analog_device": analog.device.name,
           "age_weights": args.age_weights,
           "launches": lstm_cell.lstm_gates.launches - launches0,
           "nll": res["nll"], "bpc": res["nll"] / math.log(2.0),
           "accuracy": res["accuracy"], "tokens_per_s": res["tokens_per_s"],
           "step_ms": res["step_ms"]}
    print(json.dumps(out))
    if args.profile:
        out["profile"] = profile_device(model, data, all_steps=all_steps,
                                        seed=args.seed)
        print(json.dumps({"profile": out["profile"]}))
    return out


if __name__ == "__main__":
    main()
