"""Edge-case battery: degenerate images through every engine."""

import numpy as np
import pytest

from tissue_analysis_tpu.core.spatial_image import SpatialImage
from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.engine import (
    analyze_stack_blocked,
    analyze_stack_chunked,
)

ENGINES = [analyze_stack_blocked, analyze_stack_chunked]


def _tables(img, background=1):
    stack = LabeledStack.from_array(np.asarray(img), background=background)
    return [e(stack) for e in ENGINES]


def _assert_all_equal(tables):
    a = tables[0]
    for b in tables[1:]:
        for f in ("count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
                  "wall_face_counts", "margin"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_all_background():
    img = np.ones((8, 8, 8), dtype=np.uint8)
    ts = _tables(img)
    _assert_all_equal(ts)
    t = ts[0]
    assert t.n_labels == 1 and t.n_pairs == 0
    assert t.count[0] == 512
    assert t.margin_labels() == [1]
    assert t.l1_labels() == []


def test_single_voxel_cells():
    img = np.ones((8, 8, 8), dtype=np.uint8)
    img[2, 2, 2] = 5
    img[5, 5, 5] = 7
    ts = _tables(img)
    _assert_all_equal(ts)
    t = ts[0]
    s5 = t.segment_of(5)
    assert t.count[s5] == 1
    np.testing.assert_array_equal(t.cmin[s5], [2, 2, 2])
    np.testing.assert_array_equal(t.cmax[s5], [2, 2, 2])
    # a single voxel has 6 faces with the background
    assert t.epidermis_wall_area()[s5] == 6.0
    assert sorted(t.l1_labels()) == [5, 7]


def test_no_background_label_present():
    img = np.full((8, 8, 8), 3, dtype=np.uint8)
    img[4:] = 9
    ts = _tables(img, background=1)  # background label absent
    _assert_all_equal(ts)
    t = ts[0]
    assert t.background_segment is None
    assert t.l1_labels() == []
    assert t.adjacency() == {3: [9], 9: [3]}


def test_checkerboard_dense_walls():
    """Worst-case wall density: 2-label 3D checkerboard."""
    z, y, x = np.indices((8, 8, 8))
    img = ((z + y + x) % 2 + 5).astype(np.uint8)
    ts = _tables(img, background=None)
    _assert_all_equal(ts)
    t = ts[0]
    assert t.n_pairs == 1
    # every internal face is a wall: 3 * 7 * 8 * 8 faces
    assert int(t.wall_face_counts.sum()) == 3 * 7 * 8 * 8


def test_anisotropic_wall_areas():
    img = SpatialImage(
        np.concatenate(
            [np.full((2, 4, 4), 2, np.uint8), np.full((2, 4, 4), 3, np.uint8)]
        ),
        voxelsize=(3.0, 0.5, 2.0),
    )
    stack = LabeledStack.from_array(img, voxelsize=img.voxelsize, background=None)
    t = analyze_stack_blocked(stack)
    # z-contact of 4x4 voxels, face area vy*vx = 1.0 each
    areas = t.wall_areas()
    assert areas.shape == (1,)
    assert areas[0] == 16 * 0.5 * 2.0


def test_min_sized_image():
    img = np.array([[[1, 2]]], dtype=np.uint8)  # (1, 1, 2)
    ts = _tables(img)
    _assert_all_equal(ts)
    assert ts[0].n_pairs == 1


def test_lineage_file_roundtrip(tmp_path):
    from tissue_analysis_tpu.series import read_lineage, write_lineage

    lin = {2: [5, 6], 3: [7], 10: [11, 12, 13]}
    p = str(tmp_path / "lineage.txt")
    write_lineage(p, lin)
    assert read_lineage(p) == lin
    # tolerant parser: colon-free and comment lines
    with open(p, "a") as f:
        f.write("# comment\n20 21 22\n")
    got = read_lineage(p)
    assert got[20] == [21, 22]


def test_cell_wall_surface_point_query_absent_pair():
    """Two present labels with NO shared wall -> 0 (searchsorted miss path)."""
    from tissue_analysis_tpu.analysis import SpatialImageAnalysis

    img = np.ones((4, 4, 8), dtype=np.uint8)
    img[:, :, 2:4] = 2
    img[:, :, 4:6] = 3
    img[:, :, 6:] = 4
    a = SpatialImageAnalysis(SpatialImage(img, voxelsize=(1.0, 1.0, 1.0)))
    # 2-4 are separated by 3: present labels, absent pair
    assert a.cell_wall_surface(2, 4) == 0.0
    assert a.cell_wall_surface(2, 4, real=False) == 0
    assert a.cell_wall_surface(2, 3) == 4 * 4 * 1.0
    assert a.cell_wall_surface(3, 2, real=False) == 16
