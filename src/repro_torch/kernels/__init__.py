"""Hand-written CUDA kernels, their plain torch versions, and the oracles.

Kernels build at first use (see :mod:`repro_torch.kernels._build`); importing
this package compiles nothing.
"""
