"""PyTorch port of the PARD system for NVIDIA Hopper (H100).

A second package beside the JAX reference ``repro``; it imports ``torch``
and never ``jax`` or ``repro``. The serving path (``serving.engine``) runs
its attention through the hand-written CUDA kernel in
``csrc/decode_attention_paged.cu``.
"""
