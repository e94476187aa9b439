"""Kernel launch-config sweep, output digests and parity:
``python -m repro_torch.launch.kernel_tune``.

The twin of the JAX package's ``benchmarks/kernel_tune.py``::

    python -m repro_torch.launch.kernel_tune [--quick | --full] \\
        [--out build/repro_torch/kernel_tune.json] [--device cuda|cpu]

Three jobs in one run:

* the :mod:`repro_torch.kernels.tune` sweep over the JAX sweep's kernel x
  shape grid (``--full`` adds the shapes the port's main paths launch): on
  the card every candidate config runs, must compute the default config's
  output bits, and is timed; on the CPU candidates are ranked by the
  deterministic proxy score;
* per shape, at the chosen config: the crc32 digest of the output bytes,
  the max error against the kernel's plain version, the code flips of the
  matmul kernels against it (``fused_matmul_nladc.code_flips``, on the
  effective operands for ``analog_tile``) and, on the card, the kernel's
  device time per call, timed again apart from the sweep (``us``) beside
  the sweep's own times of the winner and the default;
* the parity section: per-column ``(N, P)`` thresholds that repeat one
  bank against the ``(P,)`` bank (bitwise), the grouped expert gate
  against the ``ref`` backend (codes within LSB/2), and the
  cached-attention kernel against ``attend_full`` (1e-6); and their
  gradient halves, as the JAX sweep computes them: the largest difference
  between the gradient with respect to the expert buffer (the query) of
  the summed output through the ``cuda`` backend's Function and through
  the ``ref`` backend (:func:`expert_gate_grad_err`,
  :func:`attention_grad_err`).

It runs on the card unless ``--device cpu`` is given, and raises on a host
without a GPU otherwise.  The result (the tune cache under ``"tune"``,
which ``--kernel-cache`` and ``REPRO_TORCH_KERNEL_CACHE`` take as it is,
the shape cells and the parity section) is written to ``--out``; on the
CPU it holds no time, so its bytes repeat.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.backend import CudaBackend, get_backend
from repro_torch.core.nladc import NLADC, BankedThresholds, bank_map_for, \
    build_ramp
from repro_torch.kernels import _build, tune
from repro_torch.kernels import fused_matmul_nladc as fmn
from repro_torch.kernels import lstm_cell
from repro_torch.kernels import nladc as nk
from repro_torch.kernels import prefill_attention as pa
from repro_torch.kernels.ref import (ClosedForm, analog_tile_plain,
                                    effective_operands,
                                    fused_matmul_nladc_plain,
                                    moe_fused_matmul_plain, nladc_plain,
                                    thermometer_count)
from repro_torch.launch.common import configure_numerics, resolve_device

OUT_PATH = _build.BUILD_DIR / "kernel_tune.json"
BF16 = torch.bfloat16

# the JAX sweep's grids (benchmarks/kernel_tune.py), float32
SHAPES_QUICK = {
    "fused_matmul_nladc": [(64, 128, 256), (128, 256, 512)],
    "nladc": [(128, 512)],
    "lstm_gates": [(32, 128)],
}
SHAPES_FULL = {
    "fused_matmul_nladc": [(64, 128, 256), (128, 256, 512),
                           (512, 1024, 1024)],
    "analog_tile": [(128, 256, 256)],
    "nladc": [(128, 512), (1024, 2048)],
    "lstm_gates": [(32, 128), (128, 512)],
}
# the shapes and dtypes the port's main paths launch: qwen2.5-3b's MLP gate
# (decode, prefill and training, M = B x S = 1024: the tensor-core GEMM),
# moonshot's expert gate (per expert, timed as the grouped launch over its
# 64 experts), the MoE router and the MLP width, the PTB LSTM tail, and
# the PTB gate crossbar as one tile
SHAPES_MAIN = {
    "fused_matmul_nladc": [((4, 2048, 11008), BF16),
                           ((1, 2048, 11008), BF16),
                           ((1024, 2048, 11008), BF16),
                           ((6, 2048, 1408), BF16, 64)],
    "nladc": [((4, 64), BF16), ((4, 11008), BF16)],
    "lstm_gates": [(16, 2016)],
    "analog_tile": [((16, 632, 8064), BF16)],
}
BANK_COLS = 128
ATTN_ATOL = 1e-6


def sweep_shapes(full: bool) -> dict:
    """``{kernel: [(shape, dtype, experts), ...]}`` of a ``--quick`` or
    ``--full`` run."""
    out = {k: tune.shape_entries(v) for k, v in
           (SHAPES_FULL if full else SHAPES_QUICK).items()}
    if full:
        for k, v in SHAPES_MAIN.items():
            out.setdefault(k, []).extend(tune.shape_entries(v))
    return out


def _plain(kernel, args):
    if kernel == "fused_matmul_nladc" and len(args) == 4:
        return moe_fused_matmul_plain(*args)
    if kernel == "fused_matmul_nladc":
        return fused_matmul_nladc_plain(*args)
    if kernel == "analog_tile":
        x, w, nz, thr, dec = args
        return analog_tile_plain(x, w, nz, thr, dec)
    if kernel == "nladc":
        return nladc_plain(*args)
    return lstm_cell.lstm_gates_plain(*args)


def _flips(kernel, fn, args, blocks):
    """(flips, unexplained) of a matmul kernel's codes against the plain
    codes, the codes read from a launch that decodes ``y(n) = n``."""
    if kernel == "fused_matmul_nladc":
        x, w, thr = args[0], args[1], args[-2]
        count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32,
                             device=x.device)
        codes = fn(*args[:-1], count, blocks=blocks).long()
        xq, w_eff = x.float(), w
    else:
        x, w, nz, thr, _ = args
        codes = fn(x, w, nz, thr, ClosedForm(0, 0.0, 1.0, 1.0, 0),
                   blocks=blocks).float().long()
        xq, w_eff = effective_operands(x, w, nz)
    acc, bound = fmn.accumulator_bound(xq, w_eff)
    return fmn.code_flips(codes, thermometer_count(xq @ w_eff, thr), acc,
                          bound, thr)


def shape_cell(kernel, shape, dtype, experts, blocks, device) -> dict:
    """Digest, error against the plain version, code flips and (on the
    card) device time of one tuned shape at ``blocks``."""
    fn = tune.kernel_fn(kernel, experts)
    args = tune.kernel_inputs(kernel, shape, dtype, device,
                              experts=experts)
    got = tune.as_tuple(fn(*args, blocks=blocks))
    want = tune.as_tuple(_plain(kernel, args))
    err = max(float((g.float() - v.float()).abs().max())
              for g, v in zip(got, want))
    cell = {"blocks": list(blocks), "dtype": tune.dtype_name(dtype),
            "experts": experts, "digest": tune.digest(*got),
            "max_err_vs_plain": err,
            "code_flips": None, "unexplained_flips": None, "us": None}
    if kernel in ("fused_matmul_nladc", "analog_tile"):
        cell["code_flips"], cell["unexplained_flips"] = _flips(
            kernel, fn, args, blocks)
    if device.type == "cuda":
        cell["us"], cell["timed_by"] = tune.device_us(
            lambda: fn(*args, blocks=blocks))
    return cell


def _grad_err(fn, x, *rest) -> float:
    """The largest difference of ``d sum(fn(x)) / dx`` between the cuda
    backend's code (its kernels on the GPU, their plain versions on the
    CPU) and the ref backend."""
    grads = []
    for bk in (CudaBackend(x.device.type), get_backend("ref")):
        xg = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(fn(bk, xg, *rest)), xg)
        grads.append(g)
    return float((grads[0] - grads[1]).abs().max())


def expert_gate_grad_err(xe, we, adc, thr) -> float:
    """The expert gate's gradient half (``benchmarks/kernel_tune.py``'s
    ``moe_einsum.grad_max_err``)."""
    return _grad_err(lambda bk, a, w: bk.moe_matmul_nladc(a, w, adc, thr),
                     xe, we)


def attention_grad_err(q, kc, vc, mask) -> float:
    """The cached attention's gradient half (``attention.grad_max_err``):
    with respect to the query."""
    return _grad_err(lambda bk, a, k, v: bk.prefill_attention(a, k, v, mask),
                     q, kc, vc)


def parity_section(device, rng) -> dict:
    """The JAX sweep's parity cells."""
    ramp = build_ramp("swish", 5)
    adc = NLADC(ramp, device)
    lsb = float(ramp.lsb)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    out = {}
    # per-column thresholds repeating one bank == the (P,) bank, bitwise
    n = 256
    x = put(rng.normal(0, 1.5, (32, n)))
    w = put(rng.normal(0, 0.3, (64, n)))
    xm = put(rng.normal(0, 0.5, (16, 64)))
    flat = adc.thresholds
    cols = flat.expand(n, -1).contiguous()
    same = [torch.equal(nk.nladc(x, flat, adc.y_table),
                        nk.nladc(x, cols, adc.y_table)),
            torch.equal(fmn.fused_matmul_nladc(xm, w, None, flat,
                                               adc.y_table),
                        fmn.fused_matmul_nladc(xm, w, None, cols,
                                               adc.y_table))]
    out["banked"] = {"bitwise_equal": all(same),
                     "digest": tune.digest(nk.nladc(x, cols, adc.y_table))}

    # the grouped expert gate vs the ref backend, banked thresholds
    e_dim, c_dim, d_dim = 4, 8, 64
    bm = bank_map_for(n, BANK_COLS)
    banks = np.sort(rng.normal(0, 1, (bm.n_banks, len(ramp.thresholds))),
                    axis=1)
    bt = BankedThresholds(put(banks), bm)
    xe = put(rng.normal(0, 0.5, (e_dim, c_dim, d_dim)))
    we = put(rng.normal(0, 0.3, (e_dim, d_dim, n)))
    y_k = fmn.moe_fused_matmul(xe, we, bt.per_column, adc.y_table)
    y_r = get_backend("ref").moe_matmul_nladc(xe, we, adc, bt)
    err_lsb = float((y_k - y_r).abs().max()) / lsb
    out["moe_einsum"] = {"max_err_lsb": err_lsb, "within_half_lsb":
                         err_lsb <= 0.5,
                         "grad_max_err": expert_gate_grad_err(xe, we, adc,
                                                              bt),
                         "digest": tune.digest(y_k)}

    # the cached-attention kernel vs attend_full
    from repro_torch.nn.attention import attend_full

    b, h, hkv, d, s = 3, 8, 2, 16, 24
    q = put(rng.normal(0, 1, (b, 1, h, d)))
    kc = put(rng.normal(0, 1, (b, s, hkv, d)))
    vc = put(rng.normal(0, 1, (b, s, hkv, d)))
    mask = (torch.arange(s, device=device) < 17)[None, None, :]
    mask2 = mask[:, 0].expand(b, s).to(torch.int32).contiguous()
    o_k = pa.prefill_attention(q[:, 0].contiguous(), kc, vc, mask2)
    o_r = attend_full(q, kc, vc, mask)[:, 0]
    err = float((o_k - o_r).abs().max())
    out["attention"] = {"max_abs_err": err, "atol": ATTN_ATOL,
                        "within_atol": err <= ATTN_ATOL,
                        "bitwise_equal": bool(torch.equal(o_k, o_r)),
                        "grad_max_err": attention_grad_err(q, kc, vc,
                                                           mask),
                        "digest": tune.digest(o_k)}
    return out


def run(full: bool, device, out_path=OUT_PATH) -> dict:
    """The sweep, the shape cells and the parity section on ``device``;
    writes the result to ``out_path`` (if not empty) and returns it."""
    device = torch.device(device)
    shapes = sweep_shapes(full)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"=== kernel launch-config sweep ({tune.platform(device)}/"
          f"{tune.backend_mode(device)}, {name}) ===", flush=True)
    cache = tune.autotune(shapes, device=device)
    cells = {}
    for kernel, entries in sorted(shapes.items()):
        for shape, dtype, experts in entries:
            blocks = cache.lookup(kernel, shape, dtype, device)
            cell = shape_cell(kernel, shape, dtype, experts, blocks, device)
            entry = cache.entries[tune.cache_key(kernel, shape, dtype,
                                                 device=device)]
            cell.update(default=entry["default"],
                        candidates=entry["candidates"],
                        sweep_us=entry.get("us"),
                        default_us=entry.get("default_us"))
            key = f"{kernel}|" + "x".join(map(str, shape)) + \
                f"|{cell['dtype']}" + (f"|{experts} experts" if experts
                                       else "")
            cells[key] = cell
            timing = "" if cell["us"] is None else \
                f"  {cell['us']:8.2f} us (sweep {cell['sweep_us']:.2f}, " \
                f"default {cell['default_us']:.2f})"
            print(f"  {key:44} blocks={tuple(blocks)}  err="
                  f"{cell['max_err_vs_plain']:.2e}  digest {cell['digest']}"
                  f"{timing}", flush=True)

    parity = parity_section(device, np.random.default_rng(7))
    print(f"  banked bitwise: {parity['banked']['bitwise_equal']}   moe err "
          f"{parity['moe_einsum']['max_err_lsb']:.3f} LSB   attention err "
          f"{parity['attention']['max_abs_err']:.1e}", flush=True)
    results = {"full": full, "device": name,
               "platform": tune.platform(device),
               "backend_mode": tune.backend_mode(device),
               "tune": cache.to_dict(), "shapes": cells, "parity": parity}
    if out_path:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"  written to {out_path}", flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", dest="full", action="store_false",
                      help="the JAX sweep's quick grid (the default)")
    size.add_argument("--full", dest="full", action="store_true",
                      help="the JAX sweep's full grid and the main paths' "
                           "shapes")
    ap.add_argument("--out", default=str(OUT_PATH),
                    help="where to write the result JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.set_defaults(full=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    configure_numerics()
    return run(args.full, device, args.out)


if __name__ == "__main__":
    main()
