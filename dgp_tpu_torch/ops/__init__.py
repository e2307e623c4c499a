"""Kernels, conditionals, likelihoods and the fused CUDA conditional."""
