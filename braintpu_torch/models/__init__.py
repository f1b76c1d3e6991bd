"""Network definitions: the nnU-Net U-Nets (``unet3d``; the KAIST models and
the axial families), axial attention (``axial``), the modular U-Net
(``modular_unet``) and nnU-Net plans ingestion (``plans``)."""

from .plans import PreprocessPlan, config_from_plans, load_nnunet_plans
from .axial import (
    apply_axial_attention,
    apply_axial_block,
    axial_stage_shapes,
    init_axial_block,
    init_axial_params,
)
from .modular_unet import (
    ModularUNetConfig,
    apply_modular_unet,
    init_modular_unet,
)
from .unet3d import (
    AXIAL_UNET,
    AXIAL_UNET_FULL,
    MODEL1_BN,
    MODEL2_GN_LARGE,
    UNetConfig,
    apply_unet,
    bottleneck_features,
    decoder_channels,
    encoder_features,
    estimate_activation_bytes,
    fold_batchnorm,
    init_params,
    param_count,
)

__all__ = [
    "AXIAL_UNET",
    "AXIAL_UNET_FULL",
    "ModularUNetConfig",
    "apply_modular_unet",
    "init_modular_unet",
    "apply_axial_attention",
    "apply_axial_block",
    "init_axial_block",
    "axial_stage_shapes",
    "init_axial_params",
    "MODEL1_BN",
    "MODEL2_GN_LARGE",
    "UNetConfig",
    "apply_unet",
    "bottleneck_features",
    "decoder_channels",
    "encoder_features",
    "estimate_activation_bytes",
    "fold_batchnorm",
    "init_params",
    "param_count",
    "PreprocessPlan",
    "config_from_plans",
    "load_nnunet_plans",
]
