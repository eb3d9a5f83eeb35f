"""The plain reference: NumPy only, nothing of the program (pixels.py)."""
