"""Model configs, layers and the dense decoder LM."""
