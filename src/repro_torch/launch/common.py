"""What the launchers share: the device choice, the float settings and
the device profile."""

from __future__ import annotations

import time

import torch


def configure_numerics() -> dict:
    """Full-precision matmuls, as XLA computes them: TF32 off for float32
    matmuls and convolutions, and bfloat16 products summed in float32 and
    rounded once (no reduced-precision reduction).  Returns the flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    m = torch.backends.cuda.matmul
    return {"matmul.allow_tf32": m.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_bf16_reduced_precision_reduction":
                m.allow_bf16_reduced_precision_reduction}


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; a missing GPU raises."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return torch.device("cuda")


def device_profile(fn, *, top: int = 12):
    """Run ``fn()`` under ``torch.profiler``; returns ``(fn's result,
    profile)``: the wall time (host clock, ending on a device
    synchronize), the device's busy time (summed kernel time) and idle
    share of the wall time, and the ``top`` kernel names by device time.
    The profiler adds host time of its own, so the idle share it reports
    is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    return res, {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
                 "kernels": [{"name": name[:80], "device_ms": t / 1e3,
                              "calls": n, "share_of_busy": t / busy_us}
                             for name, t, n in kernels[:top]]}
