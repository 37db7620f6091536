"""Network-side code of the PyTorch port (the SAM selection half)."""
