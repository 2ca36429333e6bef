"""What the harness shares across configurations, mixes and metrics."""
