"""PyTorch port of the PARD system for NVIDIA Hopper (H100).

A second package beside the JAX reference ``repro``; it imports ``torch``
and never ``jax`` or ``repro``. The serving path (``serving.engine``) runs
its attention through the hand-written CUDA kernels of
``csrc/attention_tile.cuh``; training (``training.train_loop.Trainer``,
``launch.train``) runs its attention, forward and backward, through those
of ``csrc/train_attention_tile.cuh``.
"""
