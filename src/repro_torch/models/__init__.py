"""Model layers, attention and the LM of the port (dense family)."""
