"""Staged pipeline of the port: config, `CompressionPlan`, targets, CLI.

Plans are the JAX package's format (``BASE.json`` + ``BASE.npz``); this slice
runs the CNN target's export and serve stages on a plan whose earlier stages
ran elsewhere.
"""
