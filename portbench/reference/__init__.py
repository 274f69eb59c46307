"""The plain reference: plain PyTorch and numpy, nothing of the program."""
