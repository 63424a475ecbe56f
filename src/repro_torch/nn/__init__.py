"""Layers, parameter specs, the CNN zoo and the LM blocks of the port."""
