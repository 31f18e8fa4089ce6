"""Entropy coding: the host rANS coder (z), deterministic float math, and
the three CUDA kernels of the fast codec with their plain twins."""
