"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``launches`` counts, per kernel name, the launches made on CUDA tensors
since the caller last reset it; a run reads it to show that its path went
through the kernels. Calls on CPU tensors take the plain version and
count nothing.
"""
from collections import Counter

launches: Counter = Counter()
