"""parallel subpackage of the PyTorch port."""
