"""Host graph layer (numpy) and the single-device BSP engine (PyTorch)."""
