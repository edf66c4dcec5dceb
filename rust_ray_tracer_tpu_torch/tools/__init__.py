"""Measurement scripts of the port's kernels, run on a CUDA card."""
