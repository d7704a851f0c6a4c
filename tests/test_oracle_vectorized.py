"""The vectorised oracle paths equal the per-label loops they replace.

``ScipyOracle.integer_moments_vectorized`` (bincounts + sort/reduceat) must
give exactly the per-label ``integer_moments``; the walls of
``wall_face_table`` must be exactly the per-label dilation adjacency of
``neighbors()``, and every wall has at least one face.
"""

import numpy as np
import pytest

from tissue_analysis_tpu.oracle.scipy_oracle import ScipyOracle


def _checkerboard():
    z, y, x = np.indices((8, 8, 8))
    return ((z + y + x) % 2 + 5).astype(np.uint8), None


CASES = {
    "anisotropic_3d": lambda f: (f["small3d"], 1),
    "gapped_ids": lambda f: (f["gapped"], 1),
    "image_2d": lambda f: (f["small2d"], 1),
    "checkerboard": lambda f: _checkerboard(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vectorized_equals_per_label(case, small3d, gapped, small2d):
    img, background = CASES[case](
        {"small3d": small3d, "gapped": gapped, "small2d": small2d}
    )
    o = ScipyOracle(img, background=background)
    for a, b in zip(o.integer_moments(), o.integer_moments_vectorized(workers=3)):
        np.testing.assert_array_equal(a, b)
    lo, hi, counts = o.wall_face_table()
    assert counts.shape[1] == np.asarray(img).ndim
    assert (counts.sum(1) > 0).all()
    walls = set(zip(lo.tolist(), hi.tolist()))
    dilation = {
        (min(a, b), max(a, b))
        for a, nbs in o.neighbors(real=False).items()
        for b in nbs
    }
    assert walls == dilation
