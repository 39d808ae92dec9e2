"""The port's counterparts of the JAX package's ``examples/``: the
train -> COD-adapt -> serve recipe on the Markov corpus.

  python -m repro_torch.examples.pard_adaptation_train [--quick]
  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.target_independence
  python -m repro_torch.examples.serve_batched

Each runs on the CUDA card unless ``--device cpu`` is passed, and reads and
writes its checkpoints under ``artifacts_torch/`` at the repository root
(``--out``) in the format both packages read.
"""
