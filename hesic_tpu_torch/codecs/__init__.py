"""Entropy coding: the host rANS coder (z), deterministic float math, the
three CUDA kernels of the fast codec and the slot-stream encoder of the
wavefront codec, each with its plain twin (the wavefront's level-scan
kernel is in models/wavefront.py; all sources are under csrc/)."""
