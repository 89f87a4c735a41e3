"""SCDA adaptation: region mining and the adversarial train step."""
