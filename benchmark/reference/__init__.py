"""The plain reference: NumPy/Python and plain PyTorch, importing nothing
of the program. ``gm`` holds frozen copies of the port's host modules."""
