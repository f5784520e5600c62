"""SortFormer speaker diarization subpackage of the PyTorch port."""
