from .mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    create_mesh,
    current_mesh,
    replicated,
    shard_batch,
    shard_params,
    spatial_sharding,
)
from .multihost import (
    assemble_global_batch,
    global_batches,
    initialize_multihost,
    partition_files,
    process_count,
    process_device,
    process_index,
)
from .spatial import current_spatial_cut, spatial_cut
from .train import (
    DiffusionTrainStep,
    TrainState,
    init_train_state,
    make_diffusion_train_step,
    make_multi_step_train,
)

__all__ = [
    "DiffusionTrainStep",
    "Mesh",
    "Sharding",
    "TrainState",
    "assemble_global_batch",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "current_spatial_cut",
    "global_batches",
    "init_train_state",
    "initialize_multihost",
    "make_diffusion_train_step",
    "make_multi_step_train",
    "partition_files",
    "process_count",
    "process_device",
    "process_index",
    "replicated",
    "shard_batch",
    "shard_params",
    "spatial_cut",
    "spatial_sharding",
]
