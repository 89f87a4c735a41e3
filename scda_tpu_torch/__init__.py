"""scda_tpu_torch: the PyTorch/CUDA port of scda_tpu for one NVIDIA H100.

The JAX package ``scda_tpu`` is the reference; every module here holds a
counterpart of one there and is tested against it on the CPU.  Each
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/`` (built at first use, see :mod:`scda_tpu_torch.ops.kernels`),
with a plain PyTorch twin of the same signature.  A wrapper runs the twin
for CPU tensors and the kernel for CUDA tensors.

This package imports ``torch`` and never ``jax`` or ``flax``, and
nothing of the JAX package: it keeps its own copies of the host modules
it needs (``config``, ``data``, ``native``, ``evals.voc_eval``,
``evals.coco_protocol``, ``utils.logging``), each held equal to its
original by ``tests/test_torch_host.py``.

Ported: the JAX package's surface but its TPU plumbing (profiling,
Orbax checkpoints, custom partitioning): VGG16, ResNet-50/101/152 and
tiny Faster R-CNN inference in every pooling mode, multiscale RoI
pooling, source-only training, SCDA adaptation, pretrained backbones,
the FLOP counter, data parallelism over several GPUs, and the
``trainval``, ``test_net`` and ``demo`` CLIs.
"""

__version__ = "0.1.0"
