"""Host-side spatial and intensity transforms for the --data-dir recipes.

Counterpart of generativemodels_tpu/data/transforms.py, the same numpy and
scipy code: dtype-safe intensity scaling, centre crop/pad, an
interpolating resize, and the seeded random affine of the tutorials'
augmentation (`numpy.random.default_rng(seed)` as in JAX, so both draw the
same affines from one seed). Samples are fitted on the host before
batching and the copy to the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def scale_intensity(arr: np.ndarray, out_min: float = 0.0, out_max: float = 1.0) -> np.ndarray:
    """Min-max rescale to [out_min, out_max] (reference ScaleIntensity)."""
    arr = np.asarray(arr, np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        return np.full_like(arr, out_min)
    return (arr - lo) / (hi - lo) * (out_max - out_min) + out_min


def ensure_channel_first(arr: np.ndarray, spatial_dims: int) -> np.ndarray:
    """Move a small trailing channel axis to the front (reference
    EnsureChannelFirst). Image decoders yield (H, W) or channels-LAST
    (H, W, C); all fitting/augmentation here treats *leading* axes as
    channels, so an RGB(A) PNG would otherwise have its channel axis
    cropped/padded/interpolated as if it were spatial. Arrays already
    channel-first (small leading axis) or without a channel axis pass
    through unchanged."""
    arr = np.asarray(arr)
    nd = int(spatial_dims)
    if arr.ndim == nd + 1 and arr.shape[-1] <= 4 and arr.shape[0] > 4:
        return np.moveaxis(arr, -1, 0)
    return arr


def center_crop_or_pad(arr: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Center-crop and/or zero-pad trailing spatial dims to `shape`.

    `arr` may carry leading non-spatial dims (e.g. channels); only the
    last len(shape) axes are fitted (reference CenterSpatialCrop +
    SpatialPad semantics, symmetric remainder-to-the-end).
    """
    arr = np.asarray(arr)
    nd = len(shape)
    lead = arr.ndim - nd
    if lead < 0:
        raise ValueError(f"array rank {arr.ndim} < target rank {nd}")
    slices = [slice(None)] * lead
    pads = [(0, 0)] * lead
    for cur, tgt in zip(arr.shape[lead:], shape):
        if cur > tgt:
            start = (cur - tgt) // 2
            slices.append(slice(start, start + tgt))
            pads.append((0, 0))
        else:
            slices.append(slice(None))
            lo = (tgt - cur) // 2
            pads.append((lo, tgt - cur - lo))
    out = arr[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        out = np.pad(out, pads)
    return out


def resize(arr: np.ndarray, shape: Sequence[int], order: int = 1) -> np.ndarray:
    """Interpolating resize of the trailing spatial dims to `shape`.

    order=1 is linear (reference Resize default mode for images);
    order=0 nearest (label maps).
    """
    from scipy import ndimage

    arr = np.asarray(arr, np.float32)
    nd = len(shape)
    lead = arr.ndim - nd
    if lead < 0:
        raise ValueError(f"array rank {arr.ndim} < target rank {nd}")
    zoom = [1.0] * lead + [t / c for c, t in zip(arr.shape[lead:], shape)]
    if all(z == 1.0 for z in zoom):
        return arr
    # grid_mode=True: pixel-area resampling convention (cv2/skimage-style);
    # nearest boundary replicates edges instead of drooping toward zero
    return ndimage.zoom(arr, zoom, order=order, grid_mode=True, mode="nearest")


def fit_sample(
    arr: np.ndarray,
    shape: Sequence[int],
    mode: str = "crop_pad",
    rescale_intensity: bool = True,
    order: int = 1,
) -> np.ndarray:
    """Fit one sample to the fixed spatial `shape` a jitted step expects.

    mode="crop_pad" center-crops/zero-pads (preserves resolution,
    reference 3D-DDPM tutorial route); mode="resize" interpolates
    (reference 3D-LDM route). Intensity is min-max scaled to [0, 1]
    first unless disabled. `order=0` selects nearest-neighbour resizing
    (label maps).
    """
    arr = np.asarray(arr, np.float32)
    if rescale_intensity:
        arr = scale_intensity(arr)
    if mode == "crop_pad":
        return center_crop_or_pad(arr, shape)
    if mode == "resize":
        return resize(arr, shape, order=order)
    raise ValueError(f"unknown fit mode {mode!r}; use 'crop_pad' or 'resize'")


def fitted_stream(source, shape: Sequence[int], mode: str = "crop_pad"):
    """Map `fit_sample` over an iterator of samples; mode="none" passes
    through untouched (samples must already match the target shape)."""
    if mode == "none":
        return iter(source)
    return (fit_sample(a, shape, mode=mode) for a in source)


def _ranges(spec, nd: int):
    """Normalise a scalar / per-axis range spec to nd (lo, hi) pairs.

    Accepts MONAI-style specs: a scalar r meaning (-r, r) on every axis,
    a flat sequence of nd scalars, or a sequence of nd (lo, hi) pairs.
    """
    if spec is None:
        return [(0.0, 0.0)] * nd
    if np.isscalar(spec):
        return [(-float(spec), float(spec))] * nd
    spec = list(spec)
    if len(spec) != nd:
        raise ValueError(f"range spec length {len(spec)} != spatial rank {nd}")
    out = []
    for s in spec:
        if np.isscalar(s):
            out.append((-float(s), float(s)))
        else:
            lo, hi = s
            out.append((float(lo), float(hi)))
    return out


def rand_affine(
    arr: np.ndarray,
    rng: np.random.Generator,
    rotate_range=None,
    translate_range=None,
    scale_range=None,
    prob: float = 1.0,
    order: int = 1,
    spatial_dims: int | None = None,
) -> np.ndarray:
    """Random rotate/scale/translate of the trailing spatial dims.

    Host-side counterpart of the reference tutorials' augmentation
    (MONAI RandAffined with padding_mode="zeros" — e.g.
    tutorials/generative/2d_ddpm/2d_ddpm_tutorial.py:115-123): one affine
    is sampled per call and applied identically to every leading
    (channel) slice, rotating about the volume centre, so jitted train
    steps keep their static shapes while the data distribution matches
    the reference pipeline.

    rotate_range: radians. 2D takes one in-plane angle (a 1-element spec
    also accepted as MONAI does); 3D takes three (about D, H, W axes).
    translate_range: pixels per axis. scale_range: additive, factor =
    1 + u as in MONAI (0.05 -> up to ±5%). Each accepts a scalar r
    (meaning (-r, r)), per-axis scalars, or per-axis (lo, hi) pairs.
    prob: probability the transform is applied at all.
    spatial_dims: the trailing spatial rank; inferred as min(arr.ndim, 3)
    when omitted — pass 2 explicitly for channelled 2D arrays (C, H, W).
    """
    arr = np.asarray(arr, np.float32)
    if arr.ndim < 2:
        raise ValueError(f"rand_affine needs >=2 spatial dims, got rank {arr.ndim}")
    if float(rng.uniform()) >= prob:
        return arr
    nd = min(arr.ndim, 3) if spatial_dims is None else int(spatial_dims)
    if nd not in (2, 3) or nd > arr.ndim:
        raise ValueError(f"spatial_dims {nd} invalid for array rank {arr.ndim}")

    n_rot = 1 if nd == 2 else 3
    rot = [float(rng.uniform(lo, hi)) for lo, hi in _ranges(rotate_range, n_rot)]
    trans = [float(rng.uniform(lo, hi)) for lo, hi in _ranges(translate_range, nd)]
    scales = [1.0 + float(rng.uniform(lo, hi)) for lo, hi in _ranges(scale_range, nd)]

    if nd == 2:
        c, s = np.cos(rot[0]), np.sin(rot[0])
        rmat = np.array([[c, -s], [s, c]], np.float64)
    else:
        def _axis_rot(i, j, a):
            m = np.eye(3)
            m[i, i] = m[j, j] = np.cos(a)
            m[i, j] = -np.sin(a)
            m[j, i] = np.sin(a)
            return m

        # rotations about D, H, W axes in turn (MONAI axis convention)
        rmat = _axis_rot(1, 2, rot[0]) @ _axis_rot(0, 2, rot[1]) @ _axis_rot(0, 1, rot[2])
    tmat = rmat @ np.diag(scales)

    from scipy import ndimage

    spatial = arr.shape[-nd:]
    centre = (np.asarray(spatial, np.float64) - 1.0) / 2.0
    # ndimage.affine_transform maps output -> input: in = M @ out + offset.
    # Desired forward map: out = T @ (in - c) + c + t  =>  M = T^-1.
    minv = np.linalg.inv(tmat)
    offset = centre - minv @ (centre + np.asarray(trans))

    lead_shape = arr.shape[:-nd]
    flat = arr.reshape((-1,) + spatial)
    out = np.stack(
        [ndimage.affine_transform(ch, minv, offset=offset, order=order,
                                  mode="constant", cval=0.0) for ch in flat]
    )
    return out.reshape(lead_shape + spatial).astype(np.float32)


def rand_spatial_crop(arr: np.ndarray, rng: np.random.Generator, roi: Sequence[int]) -> np.ndarray:
    """Random-position crop of the trailing spatial dims to `roi`
    (reference RandSpatialCropd, random_size=False). Axes where the
    array is already <= roi are zero-padded centred instead."""
    arr = np.asarray(arr)
    nd = len(roi)
    lead = arr.ndim - nd
    if lead < 0:
        raise ValueError(f"array rank {arr.ndim} < roi rank {nd}")
    arr = center_crop_or_pad(arr, [max(c, t) for c, t in zip(arr.shape[lead:], roi)])
    slices = [slice(None)] * lead
    for cur, tgt in zip(arr.shape[lead:], roi):
        start = int(rng.integers(0, cur - tgt + 1))
        slices.append(slice(start, start + tgt))
    return arr[tuple(slices)]


def augmented_stream(
    source,
    seed: int = 0,
    rotate_range=None,
    translate_range=None,
    scale_range=None,
    prob: float = 0.5,
    spatial_dims: int | None = None,
):
    """Map `rand_affine` over an iterator of samples with a seeded RNG
    (deterministic given the seed and stream order)."""
    rng = np.random.default_rng(seed)
    return (
        rand_affine(a, rng, rotate_range=rotate_range,
                    translate_range=translate_range,
                    scale_range=scale_range, prob=prob,
                    spatial_dims=spatial_dims)
        for a in source
    )
