"""Layers, parameter specs and the CNN zoo of the port."""
