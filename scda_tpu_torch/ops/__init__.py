"""Ops of the detector: NMS, RoI-Align, and their kernels."""
