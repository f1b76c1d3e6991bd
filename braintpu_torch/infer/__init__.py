"""Whole-volume (fullconv) inference and the case-level engine."""
