"""MGNet in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``mgnet_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference. This package imports no JAX and nothing of ``mgnet_tpu``.
Public functions keep the JAX package's NHWC layouts; modules run NCHW
inside. Entry points take a ``device`` argument that defaults to
``"cuda"``; the CPU runs only when the caller asks for it.
"""

__all__ = []
