"""Plain f32 PyTorch reference of the benchmark's detectors and steps:
imports nothing of the program or of JAX."""
