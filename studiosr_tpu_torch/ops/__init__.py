"""Shared ops of the port: windows, pixel shuffle, attention, and the CUDA kernels under ``ops/cuda``."""
