"""Checkpoint loading: the flat-keyed npz trees of the reference package."""
