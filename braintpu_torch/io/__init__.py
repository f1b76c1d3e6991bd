"""I/O layer: the pure-Python NIfTI-1 codec and BraTS case discovery."""
