"""encoder of the PyTorch port."""
