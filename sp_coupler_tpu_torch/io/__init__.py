"""Output and checkpoint layer of the PyTorch port."""
