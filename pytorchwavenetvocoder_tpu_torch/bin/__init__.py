"""CLI entry points of the PyTorch port."""
