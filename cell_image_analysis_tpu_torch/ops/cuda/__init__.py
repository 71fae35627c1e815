"""Bindings for the hand-written CUDA kernels in `csrc/`."""
