"""Checkpoints: the reference's flat-keyed npz trees (read and written),
nnU-Net ``.model`` conversion and results-tree discovery."""

from .convert import (
    convert_state_dict,
    convert_torch_checkpoint,
    flatten_pytree,
    load_pytree_npz,
    load_torch_checkpoint,
    save_pytree_npz,
    unflatten_pytree,
)
from .discover import (
    DiscoveredModel,
    convert_nnunet_tree,
    discover_nnunet_tree,
)

__all__ = [
    "DiscoveredModel",
    "convert_nnunet_tree",
    "convert_state_dict",
    "convert_torch_checkpoint",
    "discover_nnunet_tree",
    "flatten_pytree",
    "load_pytree_npz",
    "load_torch_checkpoint",
    "save_pytree_npz",
    "unflatten_pytree",
]
