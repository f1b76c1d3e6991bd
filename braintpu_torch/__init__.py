"""braintpu_torch: the PyTorch/CUDA (NVIDIA H100) port of ``braintpu``.

A package of its own beside the reference package ``braintpu``, which it
is held against.  It imports ``torch``, numpy and scipy, and nothing of the
reference package or its framework.  Importing this package loads nothing
heavy; each subpackage imports what it needs.

This slice ports the ``segment`` path in fullconv mode for MODEL1_BN: NIfTI
decode, crop / z-score / pad, the folded-BN U-Net whose eligible 3x3x3
convs run on the hand-written Hopper kernel ``ops.conv3d.conv3d_tap_merged``,
8-flip mirror TTA over folds, label painting, the ET rule, uncrop, label
conventions, volumes and Dice.
"""

__version__ = "0.1.0"
