"""Checkpoint I/O of the PyTorch port (ggml-bin reader, writer, quant formats)."""
