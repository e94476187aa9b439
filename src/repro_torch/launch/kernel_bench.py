"""Kernel microbenchmark: ``python -m repro_torch.launch.kernel_bench``.

The twin of the JAX package's ``benchmarks/kernel_bench.py``::

    python -m repro_torch.launch.kernel_bench [--quick | --full] \\
        [--device cuda|cpu]

Times ``nladc`` on an ``(M, N)`` tensor and ``fused_matmul_nladc`` on
``(M, N) @ (N, 512)`` at ``(512, 1024)`` (and ``(2048, 4096)`` with
``--full``), float32, a 5-bit sigmoid ramp: the kernel beside its plain
version, each as device time per call on the card
(:func:`repro_torch.kernels.tune.device_us`), after holding the kernel to
its plain version (``nladc`` bitwise; the fused matmul's codes within the
``code_flips`` contract).  It runs on the card unless ``--device cpu`` is
given; on the CPU the wrappers take the plain versions, so it checks the
path and records no time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core.nladc import build_ramp
from repro_torch.kernels import fused_matmul_nladc as fmn
from repro_torch.kernels import nladc as nk
from repro_torch.kernels import tune
from repro_torch.kernels.ref import thermometer_count
from repro_torch.launch.common import configure_numerics, resolve_device

SHAPES_QUICK = ((512, 1024),)
SHAPES_FULL = ((512, 1024), (2048, 4096))
N_OUT = 512


def bench_shape(shape, device) -> dict:
    """Check and time both kernels at one shape."""
    rng = np.random.default_rng(0)
    ramp = build_ramp("sigmoid", 5)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = put(rng.normal(0, 1, shape))
    w = put(rng.normal(0, 0.1, (shape[1], N_OUT)))
    thr, y_table = put(ramp.thresholds), put(ramp.y_table)
    count = torch.arange(thr.shape[0] + 1, dtype=torch.float32,
                         device=device)

    def nladc():
        return nk.nladc(x, thr, y_table)

    def nladc_plain():
        return nk.nladc_plain(x, thr, y_table)

    def fused():
        return fmn.fused_matmul_nladc(x, w, None, thr, y_table)

    def fused_plain():
        return fmn.fused_matmul_nladc_plain(x, w, None, thr, y_table)

    if not torch.equal(nladc(), nladc_plain()):
        raise AssertionError(f"nladc {shape}: kernel differs from plain")
    codes = fmn.fused_matmul_nladc(x, w, None, thr, count).long()
    acc, bound = fmn.accumulator_bound(x, w)
    flips, unexplained = fmn.code_flips(
        codes, thermometer_count(x @ w, thr), acc, bound, thr)
    if unexplained or flips > 0.01 * codes.numel():
        raise AssertionError(f"fused_matmul_nladc {shape}: {flips} code "
                             f"flips, {unexplained} beyond float32 "
                             f"rounding")
    out = {"shape": list(shape), "n_out": N_OUT, "fused_code_flips": flips}
    for name, fn in (("nladc", nladc), ("nladc_plain", nladc_plain),
                     ("fused", fused), ("fused_plain", fused_plain)):
        out[f"{name}_us"] = tune.device_us(fn)[0] \
            if device.type == "cuda" else None
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", dest="full", action="store_false")
    size.add_argument("--full", dest="full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.set_defaults(full=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    configure_numerics()
    res = {"device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "shapes": [bench_shape(s, device) for s in
                      (SHAPES_FULL if args.full else SHAPES_QUICK)]}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
