"""Per-layer metric readers and the yardstick's frozen arithmetic."""
