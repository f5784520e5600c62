"""Measurement tools of the PyTorch port, each run as `python -m`."""
