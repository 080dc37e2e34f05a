"""Host data path: the native loader, transforms, and streams onto the device.

Counterpart of generativemodels_tpu/data/ for one process (the multi-host
`multihost_device_batches` is not ported yet).
"""
from .native import (
    PrefetchLoader,
    PrefetchNiftiLoader,
    load_library,
    read_image,
    read_nifti,
    write_nifti,
)
from .pipeline import (
    batched,
    batched_pairs,
    cached_dataset,
    device_batches,
    file_dataset,
    paired_stream,
    prefetch_to_device,
    training_stream,
)

__all__ = [
    "PrefetchLoader",
    "PrefetchNiftiLoader",
    "load_library",
    "read_image",
    "read_nifti",
    "write_nifti",
    "batched",
    "batched_pairs",
    "cached_dataset",
    "device_batches",
    "file_dataset",
    "paired_stream",
    "prefetch_to_device",
    "training_stream",
]
