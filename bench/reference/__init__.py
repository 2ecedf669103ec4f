"""Plain references that decide ``correct``: plain PyTorch, imported by
nothing of the program and importing nothing of it."""
