"""numpy-only helpers of the PyTorch port."""
