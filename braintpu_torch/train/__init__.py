"""Training-side helpers; this slice ports only the synthetic case generator."""
