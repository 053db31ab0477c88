"""Batched structured interior-point solver (PyTorch port)."""
