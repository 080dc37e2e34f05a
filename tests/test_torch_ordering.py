"""The port's Ordering against the JAX package's: every ordering type, with
and without each transformation, 2D and 3D; the index maps must be equal
exactly (a `random` ordering after the same numpy seed on both sides)."""
from __future__ import annotations

import numpy as np
import pytest

from generativemodels_tpu.utils.ordering import Ordering as JaxOrdering
from generativemodels_tpu_torch.utils import Ordering, OrderingTransformations, OrderingType
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (name, transformation kwargs) for a (rows, cols[, depths]) grid
TRANSFORMS = {
    "none": {},
    "transpose": dict(transpositions_axes=((1, 0),)),
    "rotate": dict(rot90_axes=((0, 1),)),
    "reflect": dict(reflected_spatial_dims=(True, False)),
    "all_reordered": dict(
        transpositions_axes=((1, 0),), rot90_axes=((0, 1), (0, 1)),
        reflected_spatial_dims=(False, True),
        transformation_order=(OrderingTransformations.REFLECT.value,
                              OrderingTransformations.ROTATE_90.value,
                              OrderingTransformations.TRANSPOSE.value),
    ),
}
GRIDS = {2: (1, 4, 6), 3: (1, 3, 4, 5)}


def _kwargs(name: str, spatial_dims: int) -> dict:
    kw = dict(TRANSFORMS[name])
    if spatial_dims == 3:  # the same transformations on a 3-axis template
        if "transpositions_axes" in kw:
            kw["transpositions_axes"] = ((1, 0, 2),)
        if "reflected_spatial_dims" in kw:
            kw["reflected_spatial_dims"] = kw["reflected_spatial_dims"] + (True,)
    return kw


@pytest.mark.parametrize("spatial_dims", [2, 3], ids=["2d", "3d"])
@pytest.mark.parametrize("transform", list(TRANSFORMS))
@pytest.mark.parametrize("ordering_type", [t.value for t in OrderingType])
def test_ordering_equals_jax(ordering_type, transform, spatial_dims):
    dims = GRIDS[spatial_dims]
    kw = _kwargs(transform, spatial_dims)
    np.random.seed(3)
    want = JaxOrdering(ordering_type, spatial_dims, dims, **kw)
    np.random.seed(3)
    got = Ordering(ordering_type, spatial_dims, dims, **kw)
    np.testing.assert_array_equal(got.get_sequence_ordering(), want.get_sequence_ordering())
    np.testing.assert_array_equal(got.get_revert_sequence_ordering(),
                                  want.get_revert_sequence_ordering())
    x = np.arange(int(np.prod(dims))) * 7
    np.testing.assert_array_equal(got(x), want(x))
    # the revert map inverts the ordering
    np.testing.assert_array_equal(got(x)[got.get_revert_sequence_ordering()], x)


def test_coordinate_lists_equal_jax():
    for depths in (None, 3):
        np.testing.assert_array_equal(Ordering.raster_scan_idx(4, 5, depths),
                                      JaxOrdering.raster_scan_idx(4, 5, depths))
        np.testing.assert_array_equal(Ordering.s_curve_idx(4, 5, depths),
                                      JaxOrdering.s_curve_idx(4, 5, depths))
        np.testing.assert_array_equal(
            Ordering.random_idx(4, 5, depths, rng=np.random.default_rng(1)),
            JaxOrdering.random_idx(4, 5, depths, rng=np.random.default_rng(1)))


def test_ordering_rejects_bad_arguments():
    with pytest.raises(ValueError):
        Ordering("zigzag", 2, (1, 4, 4))
    with pytest.raises(ValueError):
        Ordering("raster_scan", 2, (4, 4))
    with pytest.raises(ValueError):
        Ordering("raster_scan", 2, (1, 4, 4), transformation_order=("transpose", "transpose"))
    with pytest.raises(ValueError):
        Ordering("raster_scan", 2, (1, 4, 4), transformation_order=("shear",))
