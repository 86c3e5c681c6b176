"""Plain references of the benchmark's cells: plain PyTorch that imports
nothing of the program."""
