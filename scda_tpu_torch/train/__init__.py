"""Source-only training of the port: train state, step, checkpoints."""
