"""Tensor ops of the port: robust stats, similarity, quantized search, kernels."""
