"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins.

Each module holds one kernel's wrapper, its twin of the same signature,
and a launch counter on the wrapper (``<wrapper>.launches``).
"""
