"""``kernel_load_s``: the seconds the process's first use of the program's
kernel library took (finding or building it, then loading it with
ctypes), as the program records it on the host clock
(``scda_tpu_torch/ops/kernels/_build.py``'s ``first_use``): a part of
``setup_s``, several seconds where nvcc ran in this checkout.  None where
the process loaded no library or the program keeps no such record."""


def read(run):
    from scda_tpu_torch.ops.kernels import _build

    return getattr(_build, "first_use", {}).get("load_s")
