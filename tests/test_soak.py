"""Randomized soak: arbitrary label fields through every engine vs oracle.

Pure-random label fields (no spatial coherence) are the adversarial case for
the block-dictionary engines: many labels per block, dense walls — the
overflow/retry machinery must still converge to exact results.
"""

import numpy as np
import pytest

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.engine import (
    analyze_stack_blocked,
    analyze_stack_chunked,
)
from tissue_analysis_tpu.oracle.scipy_oracle import ScipyOracle

FIELDS = (
    "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


@pytest.mark.parametrize("seed", range(4))
def test_random_fields_all_engines(seed):
    rng = np.random.default_rng(seed)
    shape = tuple(rng.integers(5, 20, size=3))
    n_vals = int(rng.integers(2, 30))
    img = rng.integers(1, 1 + n_vals, size=shape).astype(np.uint16)
    stack = LabeledStack.from_array(img, background=1)

    tables = [
        analyze_stack_chunked(stack),
        analyze_stack_blocked(stack),
    ]
    # the ingest variants must land on the same bits as the resident
    # relabel path — include them in the adversarial-field matrix too
    from tissue_analysis_tpu.engine import analyze_raw
    from tissue_analysis_tpu.streaming import analyze_streamed

    tables.append(analyze_raw(img, background=1))
    tables.append(analyze_streamed(img, background=1, slab_z=8))
    a = tables[0]
    for b in tables[1:]:
        np.testing.assert_array_equal(a.ids, b.ids)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)

    oracle = ScipyOracle(img, background=1)
    vols = oracle.volume(real=False)
    for s, l in enumerate(a.ids):
        assert int(a.count[s]) == int(vols[int(l)]), l
    assert a.pair_area_map().keys() == oracle.wall_pairs().keys()
    got = {k: v for k, v in a.pair_area_map().items()}
    exp = oracle.wall_pairs(real=True)
    for k in exp:
        assert got[k] == exp[k], k


def test_float_dtype_rejected():
    with pytest.raises(TypeError):
        LabeledStack.from_array(np.ones((4, 4, 4), dtype=np.float32))
