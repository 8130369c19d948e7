"""gcm layer of the PyTorch port."""
