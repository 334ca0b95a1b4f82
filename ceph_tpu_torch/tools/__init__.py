"""Measurement scripts of the port, run on a CUDA card."""
