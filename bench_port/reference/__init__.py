"""Plain PyTorch references that decide whether a run of the port is correct.
They import nothing of the program."""
