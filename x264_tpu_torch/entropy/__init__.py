"""entropy of the PyTorch port."""
