"""The plain reference that decides ``correct``: float32 PyTorch, importing
nothing of the program."""
