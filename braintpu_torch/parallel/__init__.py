"""Parallelism across devices: the mesh, its layout rules, and the sharded
train step and inference paths (counterpart of ``braintpu/parallel``).

One process per rank (:mod:`.launch`), ``torch.distributed`` between them,
the collectives written out (:mod:`.collectives`).  The sharded fullconv
paths are ``infer.fullconv.fullconv_predict_sharded`` /
``fullconv_predict_spatial``; the engine takes a mesh
(``InferenceEngine(mesh=..., spatial_shard=...)``).
"""

from .distributed import (
    DataParallelPatchRunner,
    make_fold_parallel_forward,
    make_sharded_train_step,
    pad_folds_for_axis,
    shard_train_state,
)
from .mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    spatial_sharding,
)

__all__ = [
    "DataParallelPatchRunner",
    "make_fold_parallel_forward",
    "make_sharded_train_step",
    "pad_folds_for_axis",
    "shard_train_state",
    "batch_sharding",
    "make_mesh",
    "param_shardings",
    "replicated",
    "spatial_sharding",
]
