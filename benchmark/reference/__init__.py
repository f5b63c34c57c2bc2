"""Plain references of the models the cells run: plain PyTorch and NumPy,
importing nothing of the program under test."""
