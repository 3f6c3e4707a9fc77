"""Data-plane core (PyTorch port): config, state tensors, encoder, steps."""
