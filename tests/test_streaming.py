"""Out-of-core streamed analysis: bit-identical to the resident engines.

SURVEY.md §5 long-context analogue / VERDICT r2 missing #2: the reference is
bounded only by host RAM; `analyze_streamed` removes the rebuild's
HBM-residency bound by processing z-slabs sequentially with a carried seam
plane and exact int64 host combine.
"""

import numpy as np
import pytest

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.core.synthetic import voronoi_stack
from tissue_analysis_tpu.engine import analyze_stack
from tissue_analysis_tpu.streaming import (
    ArraySource,
    TiledSource,
    analyze_streamed,
)


def _assert_tables_equal(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    assert a.background_segment == b.background_segment
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.s1, b.s1)
    np.testing.assert_array_equal(a.s2, b.s2)
    np.testing.assert_array_equal(a.cmin, b.cmin)
    np.testing.assert_array_equal(a.cmax, b.cmax)
    np.testing.assert_array_equal(a.pair_lo, b.pair_lo)
    np.testing.assert_array_equal(a.pair_hi, b.pair_hi)
    np.testing.assert_array_equal(a.wall_face_counts, b.wall_face_counts)
    np.testing.assert_array_equal(a.margin, b.margin)


@pytest.fixture(scope="module")
def stack64():
    return np.asarray(voronoi_stack((64, 64, 64), 90, seed=4))


@pytest.mark.parametrize("slab_z", [16, 32, 40, 64, 96])
def test_streamed_bit_equals_resident(stack64, slab_z):
    # slab_z=40 exercises non-dividing slabs; 96 exercises the single
    # padded-slab path
    ref = analyze_stack(
        LabeledStack.from_array(stack64, background=1), engine="blocked"
    )
    got = analyze_streamed(
        stack64, background=1, slab_z=slab_z, engine="blocked"
    )
    _assert_tables_equal(got, ref)


def test_streamed_memmap(tmp_path, stack64):
    path = tmp_path / "stack.dat"
    mm = np.memmap(path, dtype=stack64.dtype, mode="w+", shape=stack64.shape)
    mm[:] = stack64
    mm.flush()
    ro = np.memmap(path, dtype=stack64.dtype, mode="r", shape=stack64.shape)
    ref = analyze_stack(
        LabeledStack.from_array(stack64, background=1), engine="blocked"
    )
    got = analyze_streamed(ArraySource(ro), background=1, slab_z=32)
    _assert_tables_equal(got, ref)


def test_streamed_anisotropic_voxelsize(stack64):
    got = analyze_streamed(
        stack64, background=1, slab_z=32, voxelsize=(2.0, 0.5, 0.25)
    )
    ref = analyze_stack(
        LabeledStack.from_array(
            stack64, background=1, voxelsize=(2.0, 0.5, 0.25)
        ),
        engine="blocked",
    )
    _assert_tables_equal(got, ref)
    np.testing.assert_array_equal(got.wall_areas(), ref.wall_areas())


def test_streamed_wide_dtype(stack64):
    # > 16-bit label values take the searchsorted relabel path
    wide = stack64.astype(np.int64) * 100000
    wide[stack64 == 1] = 1
    ref = analyze_stack(
        LabeledStack.from_array(wide, background=1), engine="blocked"
    )
    got = analyze_streamed(wide, background=1, slab_z=32)
    _assert_tables_equal(got, ref)


def test_tiled_source_matches_materialized(stack64):
    src = TiledSource(stack64[:32, :32, :32], (2, 1, 2), background=1)
    # materialize via read() and analyze resident — the source itself is
    # the system under test here
    full = src.read(0, src.shape[0])
    assert full.shape == src.shape
    ref = analyze_stack(
        LabeledStack.from_array(full, background=1), engine="blocked"
    )
    got = analyze_streamed(src, background=1, slab_z=16)
    _assert_tables_equal(got, ref)


def test_tiled_cell_features_bit_match_base(stack64):
    """Per-cell features of every tile replica bit-match the base stack's
    interior cells (the BASELINE.md scale-up validation recipe)."""
    base = np.asarray(stack64[:32, :32, :32])
    src = TiledSource(base, (1, 1, 2), background=1)
    t_base = analyze_stack(
        LabeledStack.from_array(base, background=1), engine="blocked"
    )
    t_tiled = analyze_streamed(src, background=1, slab_z=16)
    stride = src.stride
    # non-margin base cells keep identical voxel counts in the second tile
    for s, l in enumerate(t_base.ids):
        if t_base.margin[s] or l == 1:
            continue
        l2 = int(l) + stride
        s2 = t_tiled.segment_of(l2)
        assert s2 is not None
        assert t_tiled.count[s2] == t_base.count[s]


def test_streamed_wide_aspect_forced_twokey(monkeypatch, stack64):
    """Wide-aspect streamed regression guard (VERDICT r4 next #8): the
    cross-section ≫ slab_z shape class with the TWO-KEY sort branch forced
    (n_labels withheld from the reduce, as at real Gvox widths where
    n > 23k disables key packing). Must stay bit-identical to the resident
    engine through the per-slab composition that stalled round 4's Gvox
    compiles."""
    from tissue_analysis_tpu.ops import blocked as _blocked

    wide = np.ascontiguousarray(
        np.asarray(stack64[:16]).repeat(2, axis=1)[:, :96, :]
    )
    orig = _blocked._sorted_pair_reduce

    def force_twokey(los, his, tags, counts, max_entries, n_labels=None, **kw):
        return orig(los, his, tags, counts, max_entries, **kw)

    monkeypatch.setattr(_blocked, "_sorted_pair_reduce", force_twokey)
    got = analyze_streamed(wide, background=1, slab_z=8, engine="blocked")
    monkeypatch.undo()
    ref = analyze_stack(
        LabeledStack.from_array(wide, background=1), engine="blocked"
    )
    _assert_tables_equal(got, ref)


@pytest.mark.parametrize("max_pairs", [8, 64])
def test_streamed_retry_checks_the_config_a_slab_ran_with(max_pairs):
    """Slabs are dispatched one ahead of their collection, so the shared
    config can grow between a slab's dispatch and its check. The overflow
    check must use the config the slab RAN with: five 32-plane slabs whose
    run counts exceed a tiny explicit pair buffer, so every slab is
    truncated on its first run and must be rerun."""
    from tissue_analysis_tpu.ops.blocked import BlockConfig

    img = np.asarray(voronoi_stack((160, 48, 48), 150, seed=4, sphere=False))
    ref = analyze_stack(LabeledStack.from_array(img, background=1))
    got = analyze_streamed(
        img, background=1, slab_z=32, cfg=BlockConfig(max_pairs=max_pairs)
    )
    _assert_tables_equal(got, ref)
