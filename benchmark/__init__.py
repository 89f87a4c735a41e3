"""The benchmark of the PyTorch port (``scda_tpu_torch``) on one GPU."""
