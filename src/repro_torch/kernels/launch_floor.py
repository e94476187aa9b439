"""The launch floor: a kernel of one block that writes one word.

Built and launched through ``ctypes`` as every kernel of the port is
(``csrc/launch_floor.cu``), so its device time is what the smallest launch
costs on the card: the floor beside which the tiny cases of the
elementwise kernels are read (``chip_smoke.py`` prints it).  It is no bound
of any kernel and no model path calls it.

:func:`launch_floor` writes 1 into an int32 tensor of one element: with
``fill_`` on the CPU, with the kernel on a CUDA tensor.
``launch_floor.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _build.load("launch_floor")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    lib.launch_floor_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.launch_floor_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_floor(out: torch.Tensor) -> torch.Tensor:
    """Write 1 into ``out`` (int32, one element) and return it."""
    if out.dtype != torch.int32 or out.numel() != 1:
        raise ValueError(f"launch_floor: out must be one int32, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.device.type == "cpu":
        return out.fill_(1)
    if out.device.type != "cuda":
        raise ValueError(f"launch_floor: no kernel for {out.device}")
    lib = library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.launch_floor_launch(out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"launch_floor kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    launch_floor.launches += 1
    return out


launch_floor.launches = 0
