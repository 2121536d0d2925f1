"""Kernel wrappers with their plain PyTorch versions; the CUDA sources
are in ../csrc."""
