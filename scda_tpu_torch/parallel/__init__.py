"""Data parallelism over several devices."""
