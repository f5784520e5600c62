"""align subpackage of the PyTorch port."""
