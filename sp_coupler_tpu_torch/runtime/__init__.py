"""Run loop of the PyTorch port."""
