"""Traffic mixes (data files) and their general generator."""
