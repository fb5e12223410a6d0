"""The plain PyTorch reference of the benchmarked configurations."""
