"""Sharding equivalence: 1-device vs N-way z-slab results must be identical
(halo + psum correctness, SURVEY.md §4 item 3). Runs on the 8-virtual-device
CPU backend configured in conftest."""

import numpy as np
import pytest

import jax

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.core.synthetic import voronoi_stack
from tissue_analysis_tpu.engine import analyze_stack
from tissue_analysis_tpu.parallel import analyze_sharded, make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _assert_tables_equal(a, b):
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.s1, b.s1)
    np.testing.assert_array_equal(a.s2, b.s2)
    np.testing.assert_array_equal(a.cmin, b.cmin)
    np.testing.assert_array_equal(a.cmax, b.cmax)
    np.testing.assert_array_equal(a.pair_lo, b.pair_lo)
    np.testing.assert_array_equal(a.pair_hi, b.pair_hi)
    np.testing.assert_array_equal(a.wall_face_counts, b.wall_face_counts)
    np.testing.assert_array_equal(a.margin, b.margin)


@pytest.mark.parametrize(
    "shape,ncells,seed",
    [
        ((32, 32, 32), 40, 0),  # divisible by 8
        ((30, 24, 28), 30, 1),  # z not divisible -> padded slabs
        ((5, 16, 16), 6, 2),  # fewer z planes than devices -> all-pad slabs
    ],
)
def test_sharded_equals_single_device(shape, ncells, seed):
    img = voronoi_stack(shape, ncells, seed=seed, voxelsize=(2.0, 0.5, 0.5))
    stack = LabeledStack.from_array(img, voxelsize=img.voxelsize, background=1)
    single = analyze_stack(stack)
    mesh = make_mesh(8)
    sharded = analyze_sharded(stack, mesh=mesh)
    _assert_tables_equal(single, sharded)


def test_sharded_on_subset_mesh():
    img = voronoi_stack((24, 20, 20), 20, seed=4)
    stack = LabeledStack.from_array(img, voxelsize=img.voxelsize, background=1)
    single = analyze_stack(stack)
    for n_dev in (2, 4):
        sharded = analyze_sharded(stack, mesh=make_mesh(n_dev))
        _assert_tables_equal(single, sharded)


def test_sharded_overflow_rerun():
    img = voronoi_stack((16, 16, 16), 30, seed=5)
    stack = LabeledStack.from_array(img, voxelsize=img.voxelsize, background=1)
    single = analyze_stack(stack)
    sharded = analyze_sharded(stack, mesh=make_mesh(4), max_pairs=4)
    _assert_tables_equal(single, sharded)


@pytest.mark.parametrize(
    "shape,ncells,seed,ndev",
    [
        ((32, 32, 32), 40, 0, 8),
        ((30, 24, 28), 30, 1, 8),  # z not divisible by n_dev·bz -> pad
        ((5, 16, 16), 6, 2, 8),  # fewer z planes than devices
        ((64, 48, 40), 80, 3, 4),
    ],
)
def test_sharded_blocked_equals_single(shape, ncells, seed, ndev):
    from tissue_analysis_tpu.engine import analyze_stack_blocked
    from tissue_analysis_tpu.parallel.sharded import analyze_sharded_blocked

    img = voronoi_stack(shape, ncells, seed=seed, voxelsize=(2.0, 0.5, 0.5))
    stack = LabeledStack.from_array(img, voxelsize=img.voxelsize, background=1)
    single = analyze_stack_blocked(stack)
    sharded = analyze_sharded_blocked(stack, mesh=make_mesh(ndev))
    _assert_tables_equal(single, sharded)
