"""timestamps subpackage of the PyTorch port."""
