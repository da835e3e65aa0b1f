"""Model assembly: layers, attention and the dense decoder LM."""
