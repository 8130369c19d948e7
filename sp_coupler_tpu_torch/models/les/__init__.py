"""les layer of the PyTorch port."""
