"""Plain PyTorch references, independent of the program under test."""
