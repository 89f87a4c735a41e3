"""Backbones: VGG16 and the tiny test CNN."""
