"""Fixed-point wire helpers (the in-network tier comes in a later slice)."""
