"""Dataset evaluation."""
