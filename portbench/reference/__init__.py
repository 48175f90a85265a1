"""Plain PyTorch references of what the cells time. They import nothing of
the port and take nothing that the port made: the benchmark hands them the
inputs it made itself."""
