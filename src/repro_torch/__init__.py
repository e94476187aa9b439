"""repro_torch: the NL-ADC analog LSTM in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (``sm_90a``).

It mirrors the layout of the JAX package ``repro`` module by module and
imports nothing of it.  Entry points run on the GPU unless the caller asks
for the CPU; on a CPU tensor every kernel wrapper takes its plain torch
version.
"""
