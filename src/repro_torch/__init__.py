"""PyTorch/CUDA port of the reproduction's datapath, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
of it and nothing of JAX.  Sub-packages carry the same names as in
``repro`` (``configs``, ``kernels``, ``models``, ``serve``, ``launch``).
"""
