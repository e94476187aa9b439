"""The launch-floor kernel's wrapper: one int32 word written, on the CPU by
``fill_`` (the CUDA kernel runs in ``chip_smoke.py`` and the card tests)."""

import ctypes
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import launch_floor as TLF


def test_writes_its_word_on_the_cpu():
    word = torch.zeros(1, dtype=torch.int32)
    n0 = TLF.launch_floor.launches
    assert TLF.launch_floor(word) is word
    assert word.item() == 1 and TLF.launch_floor.launches == n0


@pytest.mark.parametrize("bad", [torch.zeros(1),
                                 torch.zeros(2, dtype=torch.int32)])
def test_rejects_other_than_one_int32(bad):
    with pytest.raises(ValueError):
        TLF.launch_floor(bad)


def test_library_declares_pointer_arguments(monkeypatch):
    fake = SimpleNamespace(
        launch_floor_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TLF._build, "load", lambda name: fake)
    lib = TLF.library()
    assert lib.launch_floor_launch.argtypes == [ctypes.c_void_p] * 2
    assert lib.launch_floor_launch.restype is ctypes.c_int
