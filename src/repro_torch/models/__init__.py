"""LM assembly of the port: architecture configs and the dense LM."""
