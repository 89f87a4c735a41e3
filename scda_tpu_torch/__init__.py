"""scda_tpu_torch: the PyTorch/CUDA port of scda_tpu for one NVIDIA H100.

The JAX package ``scda_tpu`` is the reference; every module here holds a
counterpart of one there and is tested against it on the CPU.  Each
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/`` (built at first use, see :mod:`scda_tpu_torch.ops.kernels`),
with a plain PyTorch twin of the same signature.  A wrapper runs the twin
for CPU tensors and the kernel for CUDA tensors.

This package imports ``torch`` and never ``jax`` or ``flax``.  It shares
the JAX package's host modules that import neither: ``scda_tpu.config``,
``scda_tpu.data``, ``scda_tpu.evals.voc_eval`` and ``scda_tpu.native``.

Ported so far (slices 1 and 2): VGG16, ResNet-50/101/152 and tiny
Faster R-CNN inference in the ``align`` and ``align_legacy`` pooling
modes, with multiscale RoI pooling.
"""

__version__ = "0.1.0"
