"""Coefficient operators, band modules and the GPU kernels."""
