"""Label counts beyond the round-1 ceilings (VERDICT r1 missing #2).

The reference (``spatial_image_analysis.py :: AbstractSpatialImageAnalysis``,
pure Python/int64) has no cell-count ceiling; round 1's engines capped at
n ≤ 23,169 (int32 lo·n+hi pair keys) and the chunked engine allocated dense
n² accumulators. These tests pin the lifted limits: >100k labels through the
blocked and chunked engines (bit-identical, analytic ground truth) and
sharded parity at >23k.

The per-label scipy-dilation oracle is O(n·dilation) and unusable at 100k
cells, so the fixture is a regular grid of box cells with closed-form
moments/adjacency (``core.synthetic.grid_stack``).
"""

import numpy as np
import pytest

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.core.synthetic import grid_stack
from tissue_analysis_tpu.engine import (
    analyze_stack_blocked,
    analyze_stack_chunked,
)
from tissue_analysis_tpu.ops import blocked


CELL = (4, 4, 4)
SHAPE = (160, 256, 160)  # 40·64·40 = 102,400 cells of 4³ voxels
GRID = tuple(s // c for s, c in zip(SHAPE, CELL))
N = int(np.prod(GRID))

# 16³ blocks hold exactly 4³ = 64 grid cells (+ the pad label): the default
# 32³ block would need L ≥ 512 and overflow the count·L² packing
CFG_16 = blocked.BlockConfig(block=(16, 16, 16), max_labels_per_block=96)


@pytest.fixture(scope="module")
def grid100k():
    img = grid_stack(SHAPE, CELL)
    assert img.dtype == np.int32  # beyond uint16
    return LabeledStack.from_array(np.asarray(img), background=None)


@pytest.fixture(scope="module")
def table100k(grid100k):
    return analyze_stack_blocked(grid100k, cfg=CFG_16)


def _expected_moments():
    """Closed-form count/s1/bbox for the grid fixture, in table id order
    (ids ascending 1..N ⇒ segment s holds grid cell s in C order)."""
    ii, jj, kk = np.meshgrid(*[np.arange(g) for g in GRID], indexing="ij")
    org = np.stack(
        [ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], axis=1
    ).astype(np.int64) * np.asarray(CELL, np.int64)
    vol = int(np.prod(CELL))
    # Σ coordinate d over a box = vol·origin_d + (vol/c_d)·(c_d·(c_d-1)/2)
    s1 = vol * org + np.asarray(
        [vol // c * (c * (c - 1) // 2) for c in CELL], np.int64
    )
    return org, vol, s1


def test_blocked_100k_labels_moments(grid100k, table100k):
    t = table100k
    assert t.n_labels == N
    assert np.array_equal(t.ids, np.arange(1, N + 1))
    org, vol, s1 = _expected_moments()
    assert np.all(t.count == vol)
    assert np.array_equal(t.s1, s1)
    assert np.array_equal(t.cmin, org)
    assert np.array_equal(t.cmax, org + np.asarray(CELL, np.int64) - 1)
    # margin: any grid coordinate at 0 or the far edge
    gidx = np.stack(np.unravel_index(np.arange(N), GRID), axis=1)
    exp_margin = ((gidx == 0) | (gidx == np.asarray(GRID) - 1)).any(axis=1)
    assert np.array_equal(t.margin, exp_margin)


def test_blocked_100k_labels_adjacency(table100k):
    t = table100k
    # expected pairs: grid neighbors along each axis, ascending (lo, hi)
    gidx = np.arange(N).reshape(GRID)
    pairs = []
    axis_of = []
    for ax in range(3):
        a = np.moveaxis(gidx, ax, 0)[:-1].reshape(-1)
        b = np.moveaxis(gidx, ax, 0)[1:].reshape(-1)
        pairs.append(np.stack([a, b], axis=1))
        axis_of.append(np.full(a.shape, ax))
    pairs = np.concatenate(pairs)
    axis_of = np.concatenate(axis_of)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs, axis_of = pairs[order], axis_of[order]
    assert t.n_pairs == pairs.shape[0]
    assert np.array_equal(t.pair_lo, pairs[:, 0])
    assert np.array_equal(t.pair_hi, pairs[:, 1])
    # shared face area: product of the two orthogonal cell extents
    face = np.asarray(
        [np.prod(CELL) // c for c in CELL], np.int64
    )
    exp_counts = np.zeros((pairs.shape[0], 3), np.int64)
    exp_counts[np.arange(pairs.shape[0]), axis_of] = face[axis_of]
    assert np.array_equal(t.wall_face_counts, exp_counts)


def test_chunked_matches_blocked_100k(grid100k, table100k):
    tc = analyze_stack_chunked(grid100k)
    tb = table100k
    for f in ("count", "s1", "s2", "cmin", "cmax",
              "pair_lo", "pair_hi", "wall_face_counts", "margin"):
        assert np.array_equal(getattr(tc, f), getattr(tb, f)), f


def _sharded_beyond_cap_body():
    """z-slab-sharded blocked engine at 24,576 labels (> the old 23,169
    cap), bit-equal to single-device."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from tissue_analysis_tpu.parallel.sharded import (
        analyze_sharded_blocked,
        make_mesh,
    )

    jax.clear_caches()
    shape = (96, 128, 128)  # 24·32·32 = 24,576 cells
    img = grid_stack(shape, CELL)
    stack = LabeledStack.from_array(np.asarray(img), background=None)
    single = analyze_stack_blocked(stack, cfg=CFG_16)
    sharded = analyze_sharded_blocked(stack, mesh=make_mesh(8), cfg=CFG_16)
    for f in ("count", "s1", "s2", "cmin", "cmax",
              "pair_lo", "pair_hi", "wall_face_counts", "margin"):
        assert np.array_equal(getattr(sharded, f), getattr(single, f)), f


def test_sharded_blocked_beyond_old_cap():
    """Runs `_sharded_beyond_cap_body` in a FRESH interpreter.

    The heaviest suite test: run in-process after the full suite's
    hundreds of live compiled executables, the XLA CPU runtime
    intermittently SIGABRTs the whole interpreter (observed three times in
    full-suite runs; never standalone — the identical computation passes
    in isolation, so it is accumulated-runtime-state, not a library bug).
    A subprocess makes the suite deterministic while keeping the coverage.
    """
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r); "
        "from test_high_label_counts import _sharded_beyond_cap_body; "
        "_sharded_beyond_cap_body(); print('SHARDED-OK')"
        % (os.path.dirname(__file__), os.path.dirname(os.path.dirname(__file__)))
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    assert r.returncode == 0 and "SHARDED-OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-2000:]
    )
