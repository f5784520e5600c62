"""HTTP server of the PyTorch port."""
