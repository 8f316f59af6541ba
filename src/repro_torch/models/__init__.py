"""Model code of the port: the decoder-only LM of the dense family."""
