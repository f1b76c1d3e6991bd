"""Inference preprocessing: crop to nonzero, masked z-score, pad."""
