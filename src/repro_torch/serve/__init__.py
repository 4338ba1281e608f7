"""Serving steps of the PyTorch port (one device)."""
