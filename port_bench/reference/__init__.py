"""The plain reference that decides whether a run is correct: PyTorch and numpy only, nothing of the program."""
