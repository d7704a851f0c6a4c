"""More than 2048 labels through every entry point, checked against the
plain reference (``ScipyOracle.feature_table``).

2048 = 2¹¹ is where a float one-hot id lookup would start to round under
TF32. The grid stack puts 2,560 box cells (raw ids 1..2560, 64 per 32³
block — the dictionary's default capacity) through ``analyze``,
``analyze_raw``, ``analyze_streamed``, ``analyze_sharded`` on 8 virtual
devices and ``analyze_series``; each table must equal the reference exactly.
"""

import numpy as np
import pytest

from tissue_analysis_tpu.core.synthetic import grid_stack
from tissue_analysis_tpu.oracle.scipy_oracle import ScipyOracle

SHAPE = (32, 128, 320)
CELL = (8, 8, 8)
FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


@pytest.fixture(scope="module")
def grid():
    img = np.asarray(grid_stack(SHAPE, CELL))
    ref = ScipyOracle(img, background=1).feature_table()
    assert ref.n_labels == 2560
    return img, ref


def _analyze(img):
    from tissue_analysis_tpu import analyze

    return analyze(img, background=1)


def _raw(img):
    from tissue_analysis_tpu import analyze_raw

    return analyze_raw(img, background=1)


def _streamed(img):
    from tissue_analysis_tpu import analyze_streamed

    return analyze_streamed(img, background=1, slab_z=16)


def _sharded(img):
    from tissue_analysis_tpu.core.stack import LabeledStack
    from tissue_analysis_tpu.parallel import analyze_sharded, make_mesh

    stack = LabeledStack.from_array(img, background=1)
    return analyze_sharded(stack, mesh=make_mesh(8))


def _series(img):
    from tissue_analysis_tpu import analyze_series

    a, b = analyze_series([img, img], background=1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    return b


@pytest.mark.parametrize(
    "entry", [_analyze, _raw, _streamed, _sharded, _series],
    ids=["analyze", "analyze_raw", "analyze_streamed", "analyze_sharded",
         "analyze_series"],
)
def test_many_labels_match_reference(grid, entry):
    img, ref = grid
    t = entry(img)
    assert t.background_segment == ref.background_segment
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(ref, f), f)
