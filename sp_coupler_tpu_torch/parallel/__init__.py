"""Instance parallelism of the PyTorch port over torch.distributed ranks."""
