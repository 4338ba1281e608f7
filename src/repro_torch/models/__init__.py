"""Dense decoder models of the PyTorch port (layers, attention, transformer)."""
