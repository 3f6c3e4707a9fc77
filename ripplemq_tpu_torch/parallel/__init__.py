"""Engine bindings (PyTorch port): the single-device local binding."""
