"""relationalgraphlearning_tpu_torch — the PyTorch/CUDA port.

The JAX package ``relationalgraphlearning_tpu`` beside it is the reference.
This package re-implements its paths in PyTorch for an NVIDIA H100, and each
Pallas kernel on a ported path becomes a CUDA kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

It imports ``torch`` and ``numpy`` only, never ``jax`` nor any module of the
JAX package. Entry points take ``device=`` (default ``"cuda"``); on a CPU
tensor every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
