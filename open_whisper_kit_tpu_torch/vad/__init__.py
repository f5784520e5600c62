"""vad subpackage of the PyTorch port."""
