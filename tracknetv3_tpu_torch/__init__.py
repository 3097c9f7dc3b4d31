"""PyTorch / CUDA port of the TrackNetV3 framework for one NVIDIA H100.

A package of its own beside the JAX package ``tracknetv3_tpu``, which
stays the reference the port is held against. The port imports ``torch``
and numpy, never ``jax`` nor anything of ``tracknetv3_tpu``.
"""
