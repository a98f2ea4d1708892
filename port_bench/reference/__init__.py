"""Plain PyTorch references the benchmark compares the program with."""
