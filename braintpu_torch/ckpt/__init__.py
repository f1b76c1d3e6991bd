"""Checkpoints: the reference's flat-keyed npz trees (read and written),
nnU-Net ``.model`` conversion and results-tree discovery."""
