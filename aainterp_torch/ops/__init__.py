"""Operator construction (host numpy) and application (torch, CUDA)."""
