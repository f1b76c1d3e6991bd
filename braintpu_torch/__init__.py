"""braintpu_torch: the PyTorch/CUDA (NVIDIA H100) port of ``braintpu``.

A package of its own beside the reference package ``braintpu``, which it
is held against.  It imports ``torch``, numpy and scipy, and nothing of the
reference package or its framework.  Importing this package loads nothing
heavy; each subpackage imports what it needs.

The port covers the ``segment`` path in fullconv mode for the two-model
ensemble: NIfTI decode, crop / z-score / pad, MODEL1_BN (BatchNorm folded;
its eligible 3x3x3 convs on the hand-written Hopper kernel
``ops.conv3d.conv3d_tap_merged``) and MODEL2_GN_LARGE (deferred GroupNorm;
its stride-1 3x3x3 convs on ``ops.stage.conv_stage``), the up-convs of both
on ``ops.upconv.upconv2x``, 8-flip mirror TTA over folds, the softmax-mean
ensemble, label painting, the ET rule, uncrop, label conventions, volumes
and Dice.
"""

__version__ = "0.1.0"
