"""The harness: cells from data, their runners, tracing and the output check."""
