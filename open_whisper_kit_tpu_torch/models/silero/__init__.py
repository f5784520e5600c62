"""silero subpackage of the PyTorch port."""
