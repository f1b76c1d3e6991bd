"""Training: the nnU-Net recipe (Dice + BCE deep supervision, SGD with the
poly schedule), its data loader and augmentation, checkpoints with
``torch.save``, and the synthetic case generator."""
