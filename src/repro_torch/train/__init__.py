"""Training: config, optimizer, step and loop."""
