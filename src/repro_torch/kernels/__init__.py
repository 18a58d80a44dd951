"""Attention kernels (hand-written CUDA for Hopper), their plain PyTorch versions, and dispatch."""
