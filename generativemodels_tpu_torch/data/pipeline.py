"""File iteration, batching and the copy to the device.

Counterpart of generativemodels_tpu/data/pipeline.py: host-side numpy
streams (the native loader for NIfTI, PNG and JPEG, `np.load` for .npy,
PIL where the JAX package uses it for other image files), batching, and
`prefetch_to_device`, which keeps `size` batches in flight on an explicit
device: a producer thread prepares them on the host and queues their
copies from pinned memory without blocking, so the host goes on decoding
while the device trains. Epochs come out in file order (or the
seeded shuffle order): the port's loader keeps that order with any
number of workers. A failed build of the loader raises; the JAX pipeline
falls back to Python readers there.

One process reads the whole dataset: `process_count` above 1 (the
multi-host partitioning of the JAX package) is not ported yet.
"""
from __future__ import annotations

import collections
import glob
import os
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from . import native

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
_EXTS = (".nii", ".nii.gz", ".npy") + _IMAGE_EXTS


def _single_process(process_index: int | None, process_count: int | None) -> None:
    if (process_count or 1) > 1 or (process_index or 0) != 0:
        raise NotImplementedError(
            "reading a partition of the files in each of several processes is not ported "
            "yet (ROADMAP A11); one process reads every file"
        )


def _list_files(directory: str, pattern: str = "*") -> list[str]:
    return sorted(
        p for p in glob.glob(os.path.join(directory, pattern)) if p.lower().endswith(_EXTS)
    )


def _epoch_iter(paths: list[str], num_workers: int) -> Iterator[np.ndarray]:
    """One pass over `paths` (a single extension family, already ordered), in order."""
    first = paths[0].lower()
    if first.endswith(".npy"):
        for p in paths:
            yield np.load(p).astype(np.float32)
        return
    if all(p.lower().endswith(native.NATIVE_EXTS) for p in paths):
        # C++ worker pool: NIfTI decompression and PNG/JPEG decoding run
        # without the interpreter lock, at most max_queue files ahead
        with native.PrefetchLoader(paths, num_workers=num_workers) as loader:
            yield from loader
        return

    from concurrent.futures import ThreadPoolExecutor

    # other image files: PIL in threads, a window of ~2*num_workers decodes
    # in flight ahead of the consumer, taken in submission order
    window = max(2, 2 * num_workers)
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        futures: collections.deque = collections.deque()
        try:
            for p in paths:
                futures.append(pool.submit(native._pil_decode, p))
                if len(futures) >= window:
                    yield futures.popleft().result()
            while futures:
                yield futures.popleft().result()
        finally:
            for f in futures:
                f.cancel()


def file_dataset(
    data_dir: str,
    pattern: str = "*",
    num_workers: int = 4,
    loop: bool = True,
    shuffle: bool = False,
    seed: int = 0,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Iterator[np.ndarray]:
    """Yield float32 arrays from .nii/.nii.gz, PNG/JPEG (native loader), .npy,
    or other 2D images (PIL), in sorted file order.

    With `shuffle=True` the file order is permuted every epoch by
    `numpy.random.RandomState(seed + epoch)`, as in JAX: deterministic
    given `seed`. A directory that mixes families reads one, in priority
    order NIfTI > image > npy.
    """
    _single_process(process_index, process_count)
    paths = _list_files(data_dir, pattern)
    if not paths:
        raise FileNotFoundError(f"no {'/'.join(_EXTS)} files under {data_dir}/{pattern}")

    nifti_paths = [p for p in paths if p.endswith((".nii", ".nii.gz"))]
    npy_paths = [p for p in paths if p.endswith(".npy")]
    image_paths = [p for p in paths if p.lower().endswith(_IMAGE_EXTS)]
    family = nifti_paths or image_paths or npy_paths

    epoch = 0
    while True:
        epoch_paths = family
        if shuffle:
            rng = np.random.RandomState((seed + epoch) & 0x7FFFFFFF)
            epoch_paths = list(family)
            rng.shuffle(epoch_paths)
        count = 0
        for arr in _epoch_iter(epoch_paths, num_workers):
            count += 1
            yield arr
        if count == 0:
            # every file failed to decode: looping would spin forever
            raise IOError(f"no readable samples among {len(family)} files in {data_dir}")
        epoch += 1
        if not loop:
            return


def cached_dataset(
    source: Iterable[np.ndarray],
    shuffle: bool = True,
    seed: int = 0,
    loop: bool = True,
    max_bytes: int | None = 8 * 2**30,
) -> Iterator[np.ndarray]:
    """Materialise a finite sample stream in host RAM once, then re-yield it
    every epoch without decoding again (the reference CacheDataset role).

    `source` must be finite and hold only deterministic preprocessing (cache
    after fitting, before augmentation). Epoch order is reshuffled from
    `seed` + epoch index; `max_bytes` guards against caching a
    larger-than-RAM dataset (None disables the guard).
    """
    samples: list[np.ndarray] = []
    total = 0
    for a in source:
        a = np.asarray(a)
        total += a.nbytes
        if max_bytes is not None and total > max_bytes:
            raise MemoryError(
                f"cached_dataset exceeds max_bytes={max_bytes} after "
                f"{len(samples) + 1} samples; raise the limit or stream "
                "with file_dataset(shuffle=True) instead"
            )
        samples.append(a)
    if not samples:
        raise ValueError("cached_dataset: source yielded no samples")
    epoch = 0
    while True:
        order = np.arange(len(samples))
        if shuffle:
            np.random.RandomState((seed + epoch) & 0x7FFFFFFF).shuffle(order)
        for i in order:
            yield samples[i]
        epoch += 1
        if not loop:
            return


def training_stream(
    data_dir: str,
    shape,
    fit: str = "crop_pad",
    cache: bool = False,
    augment: bool = False,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """The host-side training stream the recipes share: decode -> fit to
    `shape` -> (optional) RAM cache -> (optional) the tutorials' random
    affine (rotate +-pi/36, translate +-1 px, scale +-5%, prob 0.5)."""
    from .transforms import augmented_stream, ensure_channel_first, fitted_stream

    nd = len(tuple(shape))

    def _fitted(source):
        return fitted_stream((ensure_channel_first(a, nd) for a in source), shape, fit)

    if cache:
        stream: Iterator[np.ndarray] = cached_dataset(
            _fitted(file_dataset(data_dir, loop=False)), shuffle=True, seed=seed,
        )
    else:
        stream = _fitted(file_dataset(data_dir, shuffle=True, seed=seed))
    if augment:
        stream = augmented_stream(
            stream, seed=seed, rotate_range=np.pi / 36, translate_range=1.0,
            scale_range=0.05, prob=0.5, spatial_dims=nd,
        )
    return stream


def device_batches(
    data_dir: str,
    shape,
    batch: int,
    fit: str = "crop_pad",
    cache: bool = False,
    augment: bool = False,
    seed: int = 0,
    prefetch: int = 2,
    device: torch.device | str = "cuda",
) -> Iterator[torch.Tensor]:
    """`training_stream` -> `batched` -> (B, 1, *shape) float32 on `device`.

    The one `--data-dir` path of the training recipes: fitted
    single-channel samples are stacked, reshaped to the (B, C, *spatial)
    layout the networks take, and kept `prefetch` batches in flight on the
    device ahead of the step.
    """
    stream = training_stream(data_dir, shape, fit, cache=cache, augment=augment, seed=seed)
    target = (batch, 1) + tuple(shape)
    return prefetch_to_device(
        (np.asarray(b, np.float32).reshape(target) for b in batched(stream, batch)),
        size=prefetch, device=device,
    )


def _read_any(path: str) -> np.ndarray:
    """Read one sample file by extension (npy / NIfTI / image)."""
    p = path.lower()
    if p.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if p.endswith((".nii", ".nii.gz")):
        return native.read_nifti(path)
    if p.endswith(native.NATIVE_EXTS):
        return native.read_image(path)
    return native._pil_decode(path)


def _read_label(path: str) -> np.ndarray:
    """Read a label map keeping its raw integer class values.

    Image decoders rescale by the source bit depth: right for
    intensities, wrong for class ids ({0, 1, 2} would become {0, 1/255,
    2/255}). PNG/JPEG label maps go through the native decoder unscaled,
    other image files through PIL unscaled; npy/NIfTI come through
    unscaled already.
    """
    p = path.lower()
    if p.endswith((".png", ".jpg", ".jpeg")):
        return native.read_image(path, raw=True)
    if p.endswith(_IMAGE_EXTS):
        return native._pil_decode(path, raw=True)
    return _read_any(path)


def paired_stream(
    image_dir: str,
    label_dir: str,
    shape,
    fit: str = "crop_pad",
    seed: int = 0,
    loop: bool = True,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Aligned (image, label) pairs for the conditional recipes.

    Files in the two directories pair by sorted order (counts must match);
    each epoch applies one permutation, `RandomState(seed + epoch)`, to
    both. Images are rescaled to [0, 1] and fitted with `fit`; label maps
    keep their raw values and fit nearest-neighbour (zero-pad, or order-0
    resize).
    """
    from .transforms import ensure_channel_first, fit_sample

    _single_process(process_index, process_count)
    images, labels = _list_files(image_dir), _list_files(label_dir)
    if not images:
        raise FileNotFoundError(f"no samples under {image_dir}")
    if len(images) != len(labels):
        raise ValueError(
            f"{len(images)} images vs {len(labels)} labels: directories "
            "must pair 1:1 by sorted filename"
        )

    nd = len(tuple(shape))
    epoch = 0
    while True:
        order = np.arange(len(images))
        np.random.RandomState((seed + epoch) & 0x7FFFFFFF).shuffle(order)
        for i in order:
            img = ensure_channel_first(_read_any(images[i]), nd)
            lab = ensure_channel_first(_read_label(labels[i]), nd)
            if fit == "none":  # the same pass-through contract as fitted_stream
                yield img, lab
            else:
                yield (
                    fit_sample(img, shape, fit),
                    fit_sample(lab, shape, fit, rescale_intensity=False, order=0),
                )
        epoch += 1
        if not loop:
            return


def _chunks(source: Iterable, batch_size: int) -> Iterator[list]:
    """Group an iterator into full lists of `batch_size` (drops remainder)."""
    buf: list = []
    for item in source:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []


def batched(source: Iterable[np.ndarray], batch_size: int) -> Iterator[np.ndarray]:
    """Stack fixed-shape samples into (B, ...) batches (drops remainder)."""
    return (np.stack(buf) for buf in _chunks(source, batch_size))


def batched_pairs(source: Iterable[tuple], batch_size: int) -> Iterator[tuple]:
    """Stack an iterator of sample tuples into tuples of (B, ...) batches
    (drops remainder): `batched` for paired_stream's output."""
    return (
        tuple(np.stack(part) for part in zip(*buf))
        for buf in _chunks(source, batch_size)
    )


def _to_device(batch, device: torch.device):
    """A batch (array, tensor, or tuple/list/dict of them) on `device`: from
    pinned memory with a non-blocking copy when the device is a GPU."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    tensor = torch.as_tensor(batch)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


class _Failed:
    """The producer's exception, carried to the consumer."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


_END = object()


def prefetch_to_device(
    iterator: Iterable, size: int = 2, device: torch.device | str = "cuda"
) -> Iterator:
    """Keep `size` batches in flight on `device` ahead of the consumer.

    A producer thread pulls batches from `iterator` (decoding, fitting and
    augmenting on the host) and queues their copies (pinned host memory,
    non-blocking, on the current stream), so the host prepares the next
    batches while the consumer waits for the device. Batches come out in
    the order `iterator` yields them; the producer's exception, if any, is
    raised to the consumer. Closing the generator stops the producer.
    """
    device = torch.device(device)
    ready: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            for batch in iterator:
                if not put(_to_device(batch, device)):
                    return
            put(_END)
        except BaseException as exc:  # carried to the consumer and raised there
            put(_Failed(exc))

    thread = threading.Thread(target=produce, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = ready.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join()
