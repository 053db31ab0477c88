"""Example configurations (PyTorch port)."""
