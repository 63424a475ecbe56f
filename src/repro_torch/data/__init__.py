"""Synthetic datasets of the port."""
