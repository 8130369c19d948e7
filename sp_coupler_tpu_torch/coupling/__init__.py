"""coupling layer of the PyTorch port."""
