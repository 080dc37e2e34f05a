"""Sequence orderings that project 2D/3D latent grids onto 1D token streams.

Counterpart of generativemodels_tpu/utils/ordering.py (`Ordering`): the
same numpy index maps, built once on the host. The autoregressive inferer
gathers with them (`x[:, ordering.get_sequence_ordering()]`) and scatters
back with `get_revert_sequence_ordering()`. A `random` ordering shuffles
with numpy's global generator, as the JAX module does, so two orderings
built after the same `np.random.seed` are equal.
"""
from __future__ import annotations

import numpy as np

from .enums import OrderingTransformations, OrderingType


class Ordering:
    """A 1D permutation of a 2D or 3D latent grid.

    Args:
        ordering_type: one of OrderingType: ``raster_scan`` (row-major),
            ``s_curve`` (boustrophedon; in 3D the depth direction also
            alternates with column parity) or ``random``.
        spatial_dims: 2 or 3.
        dimensions: the grid's shape with a leading (channel) axis, length
            ``spatial_dims + 1``; only the trailing spatial axes count.
        reflected_spatial_dims: per-axis booleans, the axes to flip.
        transpositions_axes: axis tuples of successive transposes.
        rot90_axes: axis-pair tuples of successive 90-degree rotations.
        transformation_order: the order in which the three transformations
            apply to the index template.
    """

    def __init__(
        self,
        ordering_type: str,
        spatial_dims: int,
        dimensions: tuple[int, ...],
        reflected_spatial_dims: tuple[bool, ...] = (),
        transpositions_axes: tuple[tuple[int, ...], ...] = (),
        rot90_axes: tuple[tuple[int, ...], ...] = (),
        transformation_order: tuple[str, ...] = (
            OrderingTransformations.TRANSPOSE.value,
            OrderingTransformations.ROTATE_90.value,
            OrderingTransformations.REFLECT.value,
        ),
    ) -> None:
        self.ordering_type = ordering_type
        if self.ordering_type not in list(OrderingType):
            raise ValueError(
                f"ordering_type must be one of {list(OrderingType)}, got {self.ordering_type}."
            )
        self.spatial_dims = spatial_dims
        self.dimensions = dimensions
        if len(dimensions) != spatial_dims + 1:
            raise ValueError(
                f"dimensions must be of length {spatial_dims + 1}, but got {len(dimensions)}."
            )
        self.reflected_spatial_dims = reflected_spatial_dims
        self.transpositions_axes = transpositions_axes
        self.rot90_axes = rot90_axes
        if len(set(transformation_order)) != len(transformation_order):
            raise ValueError(f"No duplicates are allowed. Received {transformation_order}.")
        for t in transformation_order:
            if t not in list(OrderingTransformations):
                raise ValueError(
                    f"Valid transformations are {list(OrderingTransformations)} but received {t}."
                )
        self.transformation_order = transformation_order

        self.template = self._transformed_template()
        self._sequence_ordering = self._order_template(self.template)
        self._revert_sequence_ordering = np.argsort(self._sequence_ordering)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x[self._sequence_ordering]

    def get_sequence_ordering(self) -> np.ndarray:
        return self._sequence_ordering

    def get_revert_sequence_ordering(self) -> np.ndarray:
        return self._revert_sequence_ordering

    def _transformed_template(self) -> np.ndarray:
        spatial_shape = self.dimensions[1:]
        template = np.arange(int(np.prod(spatial_shape))).reshape(*spatial_shape)
        for transformation in self.transformation_order:
            if transformation == OrderingTransformations.TRANSPOSE.value:
                for axes in self.transpositions_axes:
                    template = np.transpose(template, axes=axes)
            elif transformation == OrderingTransformations.ROTATE_90.value:
                for axes in self.rot90_axes:
                    template = np.rot90(template, axes=axes)
            elif transformation == OrderingTransformations.REFLECT.value:
                for axis, to_reflect in enumerate(self.reflected_spatial_dims):
                    if to_reflect:
                        template = np.flip(template, axis=axis)
        return template

    def _order_template(self, template: np.ndarray) -> np.ndarray:
        if self.ordering_type == OrderingType.RASTER_SCAN.value:
            return np.ascontiguousarray(template).ravel()
        if self.ordering_type == OrderingType.S_CURVE.value:
            return self._s_curve(template)
        flat = np.ascontiguousarray(template).ravel().copy()
        np.random.shuffle(flat)
        return flat

    @staticmethod
    def _s_curve(template: np.ndarray) -> np.ndarray:
        t = np.ascontiguousarray(template).copy()
        if t.ndim == 3:
            t[:, 1::2, :] = t[:, 1::2, ::-1]  # depth alternates with column parity
            t[1::2, :, :] = t[1::2, ::-1, :]  # columns alternate with row parity
        else:
            t[1::2, :] = t[1::2, ::-1]
        return t.ravel()

    @staticmethod
    def raster_scan_idx(rows: int, cols: int, depths: int | None = None) -> np.ndarray:
        """Row-major (r, c[, d]) coordinate list."""
        ranges = [np.arange(rows), np.arange(cols)]
        if depths:
            ranges.append(np.arange(depths))
        grid = np.meshgrid(*ranges, indexing="ij")
        return np.stack(grid, axis=-1).reshape(-1, len(ranges))

    @staticmethod
    def s_curve_idx(rows: int, cols: int, depths: int | None = None) -> np.ndarray:
        """Boustrophedon coordinate list: columns alternate with row parity;
        in 3D depth alternates with (original) column parity."""
        coords = Ordering.raster_scan_idx(rows, cols, depths)
        if depths:
            coords = coords.reshape(rows, cols, depths, 3)
            coords[:, 1::2, :, :] = coords[:, 1::2, ::-1, :]
            coords[1::2, :, :, :] = coords[1::2, ::-1, :, :]
            return coords.reshape(-1, 3)
        coords = coords.reshape(rows, cols, 2)
        coords[1::2, :, :] = coords[1::2, ::-1, :]
        return coords.reshape(-1, 2)

    @staticmethod
    def random_idx(
        rows: int, cols: int, depths: int | None = None, rng: np.random.Generator | None = None
    ) -> np.ndarray:
        """Shuffled coordinate list, from `rng` when given, else numpy's
        global generator."""
        coords = Ordering.raster_scan_idx(rows, cols, depths)
        if rng is None:
            np.random.shuffle(coords)
        else:
            rng.shuffle(coords)
        return coords
