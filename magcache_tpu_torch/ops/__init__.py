"""Ops: plain PyTorch compositions and the hand-written Hopper kernels."""
