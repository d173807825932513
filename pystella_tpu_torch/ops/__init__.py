"""Operators and the hand-written CUDA kernels of the PyTorch port."""
