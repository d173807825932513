"""Physics models of the PyTorch port."""
