"""Kernels: plain PyTorch versions (``ref``) and hand-written CUDA kernels
for Hopper (``flash_attention``, ``decode_attention``, ``ssd_scan``),
dispatched on the tensor's device by ``ops``.  Nothing is compiled at
import: each CUDA source is built with nvcc at its first launch
(``_build``)."""
