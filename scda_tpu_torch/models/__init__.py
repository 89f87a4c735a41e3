"""Faster R-CNN modules and the inference pipeline."""
