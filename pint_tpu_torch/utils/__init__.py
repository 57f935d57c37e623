"""Utilities: CUDA-event timing."""
