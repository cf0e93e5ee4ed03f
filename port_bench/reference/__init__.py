"""The plain reference of the benchmarked models (PyTorch and NumPy only)."""
