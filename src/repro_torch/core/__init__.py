"""Core numerics of the port: QAT quantizers, im2col, matmul dims, export."""
