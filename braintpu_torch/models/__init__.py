"""Network definitions: the nnU-Net U-Nets (``unet3d``; the KAIST models and
the axial families), axial attention (``axial``), the modular U-Net
(``modular_unet``) and nnU-Net plans ingestion (``plans``)."""
