"""Network definitions; this slice ports the folded-BN 3D U-Net forward."""
