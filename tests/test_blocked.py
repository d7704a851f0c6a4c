"""Blocked (scatter-free) engine vs chunked engine — bit-identical contract.

The blocked engine (ops/blocked.py) must reproduce the chunked engine's
FeatureTable exactly: same moments, same bbox, same pair COO in the same
order, same margins (SURVEY.md §4 item 1 exactness bar applies between
engines too, not just vs the scipy oracle).
"""

import dataclasses

import numpy as np
import pytest

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.core.synthetic import (
    single_cube_image,
    two_slab_image,
    voronoi_stack,
)
from tissue_analysis_tpu.engine import (
    analyze_stack_blocked,
    analyze_stack_chunked,
)
from tissue_analysis_tpu.ops.blocked import BlockConfig

FIELDS = (
    "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def assert_equal_tables(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _cmp(img, background=1, cfg=None):
    stack = LabeledStack.from_array(np.asarray(img), background=background)
    a = analyze_stack_blocked(stack, cfg=cfg)
    b = analyze_stack_chunked(stack)
    assert_equal_tables(a, b)
    return a


@pytest.mark.parametrize(
    "shape,ncells,seed",
    [
        ((32, 32, 32), 40, 0),
        ((33, 37, 41), 30, 3),  # not block-divisible -> pad path
        ((64, 64, 64), 120, 0),
        ((16, 48, 80), 25, 5),  # anisotropic grid
    ],
)
def test_blocked_equals_chunked(shape, ncells, seed):
    _cmp(voronoi_stack(shape, ncells, seed=seed))


def test_blocked_edge_cases():
    _cmp(single_cube_image())
    _cmp(two_slab_image(), background=None)


def test_blocked_gapped_ids():
    img = np.asarray(voronoi_stack((16, 16, 16), 10, seed=2)).astype(np.int64)
    img[img > 1] += 100
    img[img == 105] = 900
    _cmp(img)


def test_blocked_overflow_reruns():
    # L=4 forces dictionary overflow; kp=2 forces pair-compaction overflow;
    # max_pairs=2 forces the global rerun — all must converge to the same
    # exact result
    img = voronoi_stack((32, 32, 32), 40, seed=0)
    cfg = BlockConfig(max_labels_per_block=4, max_pairs_per_block=2, max_pairs=2)
    _cmp(img, cfg=cfg)


def test_blocked_small_blocks():
    img = voronoi_stack((24, 24, 24), 20, seed=1)
    cfg = BlockConfig(block=(8, 8, 8), max_labels_per_block=16)
    _cmp(img, cfg=cfg)


def test_blocked_single_block():
    img = voronoi_stack((16, 16, 16), 8, seed=4)
    cfg = BlockConfig(block=(16, 16, 16))
    _cmp(img, cfg=cfg)  # no seams at all


def test_2d_blocked_matches_chunked():
    """2D images ride the blocked engine via the z=1 lift (VERDICT r1 weak
    #5) and must stay bit-identical to the chunked 2D path."""
    import numpy as np

    from tissue_analysis_tpu.core.stack import LabeledStack
    from tissue_analysis_tpu.core.synthetic import voronoi_stack
    from tissue_analysis_tpu.engine import (
        analyze_stack_blocked,
        analyze_stack_chunked,
    )

    img = voronoi_stack((96, 80), 60, seed=4, voxelsize=(0.5, 2.0))
    stack = LabeledStack.from_array(np.asarray(img), background=1)
    tc = analyze_stack_chunked(stack)
    tb = analyze_stack_blocked(stack)
    assert tb.shape == tc.shape and tb.voxelsize == tc.voxelsize
    for f in ("count", "s1", "s2", "cmin", "cmax",
              "pair_lo", "pair_hi", "wall_face_counts", "margin"):
        assert np.array_equal(getattr(tb, f), getattr(tc, f)), f


def test_assemble_pairs_packed_matches_unpacked():
    """The packed readback form (unpack=False: single key + 1-element n4
    marker) must decode to exactly the unpacked (k1, k2) result."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(7)
    n = 500
    m = 4096
    lo = rng.integers(0, n - 1, size=m).astype(np.int32)
    hi = (lo + rng.integers(1, 8, size=m)).clip(max=n - 1).astype(np.int32)
    tags = rng.integers(0, 3, size=m).astype(np.int32)
    counts = rng.integers(1, 100, size=m).astype(np.int32)
    # sprinkle sentinel entries (IMAX) like real compaction padding
    sent = rng.random(m) < 0.2
    lo[sent] = np.int32(2**31 - 1)
    hi[sent] = np.int32(2**31 - 1)
    counts[sent] = 0
    args = tuple(jnp.asarray(a) for a in (lo, hi, tags, counts))
    max_entries = m

    k1u, k2u, tu, nru = blocked._sorted_pair_reduce(
        *args, max_entries, n_labels=n, unpack=True
    )
    k1p, k2p, tp, nrp = blocked._sorted_pair_reduce(
        *args, max_entries, n_labels=n, unpack=False
    )
    assert k2p.shape == (1,) and int(k2p[0]) == 4 * n
    assert int(nru) == int(nrp)
    ru = blocked.assemble_pairs(*map(np.asarray, (k1u, k2u, tu)))
    rp = blocked.assemble_pairs(*map(np.asarray, (k1p, k2p, tp)))
    for a, b in zip(ru, rp):
        np.testing.assert_array_equal(a, b)


def test_entry_cap_compaction_bit_identical():
    """The pre-sort live-entry compaction (entry_cap > 0) must produce the
    exact same reduced pair table as the uncapped path, and n_live must
    count live entries exactly (even when the cap overflows)."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(11)
    n = 300
    m = 10000
    lo = rng.integers(0, n - 1, size=m).astype(np.int32)
    hi = (lo + rng.integers(1, 6, size=m)).clip(max=n - 1).astype(np.int32)
    tags = rng.integers(0, 3, size=m).astype(np.int32)
    counts = rng.integers(1, 50, size=m).astype(np.int32)
    sent = rng.random(m) < 0.85  # realistic: mostly sentinel padding
    lo[sent] = np.int32(2**31 - 1)
    hi[sent] = np.int32(2**31 - 1)
    counts[sent] = 0
    n_live_true = int((~sent).sum())
    args = tuple(jnp.asarray(a) for a in (lo, hi, tags, counts))
    max_entries = m

    ref = blocked._sorted_pair_reduce(
        *args, max_entries, n_labels=n, unpack=False,
        return_live=True,
    )
    assert int(ref[4]) == n_live_true and not bool(ref[5])

    cap = (n_live_true // 256 + 2) * 256
    got = blocked._sorted_pair_reduce(
        *args, max_entries, n_labels=n, unpack=False,
        entry_cap=cap, return_live=True,
    )
    assert int(got[4]) == n_live_true and not bool(got[5])
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # overflowing cap: n_live still exact, overflow flag fires
    ovf = blocked._sorted_pair_reduce(
        *args, max_entries, n_labels=n, unpack=False,
        entry_cap=256, return_live=True,
    )
    assert int(ovf[4]) == n_live_true and bool(ovf[5])


def test_blocked_max_pairs_tightening_bit_identical():
    """After a successful default-cfg run, analyze_stack_blocked tightens
    max_pairs from the measured n_runs (VERDICT r4 weak #3: the untightened
    24·n buffers are ~226 MB of readback payload at 262k labels). The
    second (tightened) run must be bit-identical."""
    from tissue_analysis_tpu import engine

    img = np.asarray(voronoi_stack((32, 48, 48), 80, seed=6))
    stack = LabeledStack.from_array(img, background=1)
    key = ("blocked", stack.shape, stack.n_labels)
    engine._GOOD_CFG.pop(key, None)
    t1 = analyze_stack_blocked(stack)
    good = engine._GOOD_CFG.get(key)
    assert good is not None and good.max_pairs > 0  # tightened
    assert good.max_pairs < BlockConfig().derived_max_pairs(stack.n_labels)
    t2 = analyze_stack_blocked(stack)
    assert_equal_tables(t1, t2)


def test_twokey_twopass_sort_matches_legacy():
    """The two-pass stable single-key lowering of the lexicographic
    (k1, k2) sort (the round-5 fix for the 7M-entry num_keys=2 compile
    stall, BASELINE.md) must be bit-identical to the legacy num_keys=2
    path — both at the _lex_sort2 level and through the full two-key
    _sorted_pair_reduce branch (n > 23,170 so packing is ineligible)."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(13)
    n = 40000  # 4n^2 >= 2^31 -> two-key branch
    m = 20000
    lo = rng.integers(0, n - 1, size=m).astype(np.int32)
    hi = (lo + rng.integers(1, 9, size=m)).clip(max=n - 1).astype(np.int32)
    tags = rng.integers(0, 3, size=m).astype(np.int32)
    counts = rng.integers(1, 100, size=m).astype(np.int32)
    sent = rng.random(m) < 0.4
    lo[sent] = np.int32(2**31 - 1)
    hi[sent] = np.int32(2**31 - 1)
    counts[sent] = 0
    args = tuple(jnp.asarray(a) for a in (lo, hi, tags, counts))
    max_entries = m // 2

    old = blocked._TWO_KEY_SORT_MODE
    try:
        blocked._TWO_KEY_SORT_MODE = "twopass"
        got = blocked._sorted_pair_reduce(
            *args, max_entries, n_labels=n, unpack=True
        )
        s_tp = blocked._lex_sort2(args[0], args[1], args[3])
        blocked._TWO_KEY_SORT_MODE = "legacy"
        ref = blocked._sorted_pair_reduce(
            *args, max_entries, n_labels=n, unpack=True
        )
        s_lg = blocked._lex_sort2(args[0], args[1], args[3])
    finally:
        blocked._TWO_KEY_SORT_MODE = old
    for a, b in zip(s_tp, s_lg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_total_cumdiff_matches_segscan():
    """The cumsum-difference run totals (round-5 fix for the ~27-min
    `_chunked_segsum` compile at multi-M entries) must be bit-identical to
    the segmented-scan path — two-key branch, packed branch, and the
    packed entry-cap (presorted) branch."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(17)
    m = 30000
    for n, cap in ((40000, 0), (500, 0), (500, 8192)):
        lo = rng.integers(0, n - 1, size=m).astype(np.int32)
        hi = (lo + rng.integers(1, 9, size=m)).clip(max=n - 1).astype(np.int32)
        tags = rng.integers(0, 3, size=m).astype(np.int32)
        counts = rng.integers(1, 100, size=m).astype(np.int32)
        sent = rng.random(m) < 0.5
        lo[sent] = np.int32(2**31 - 1)
        hi[sent] = np.int32(2**31 - 1)
        counts[sent] = 0
        args = tuple(jnp.asarray(a) for a in (lo, hi, tags, counts))
        max_entries = m // 2
        old = blocked._RUN_TOTAL_MODE
        try:
            blocked._RUN_TOTAL_MODE = "cumdiff"
            got = blocked._sorted_pair_reduce(
                *args, max_entries, n_labels=n, unpack=True, entry_cap=cap
            )
            blocked._RUN_TOTAL_MODE = "segscan"
            ref = blocked._sorted_pair_reduce(
                *args, max_entries, n_labels=n, unpack=True, entry_cap=cap
            )
        finally:
            blocked._RUN_TOTAL_MODE = old
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_blocked_packed_moments_match_host_assembly():
    """Device-side base-2^32 packing of the blocked moment table
    (pack_moments_blocked, round 5: 46 -> 26 readback columns) must decode
    to exactly the host split-column assembly for every wshift in range."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(23)
    n = 301
    for wshift in (9, 12, 16):
        # split columns: each int32 part nonnegative; magnitudes chosen so
        # values stress all four limbs (up to ~2^60)
        table = np.zeros((n, 40), dtype=np.int32)
        table[:, 0::2] = rng.integers(0, 2**31 - 1, size=(n, 20))
        table[:, 1::2] = rng.integers(0, 2**28, size=(n, 20))
        gmin = rng.integers(0, 500, size=(n, 3)).astype(np.int32)
        gmax = gmin + rng.integers(0, 500, size=(n, 3)).astype(np.int32)
        ref = blocked.assemble_moments(table, gmin, gmax, wshift)
        words = np.asarray(
            blocked.pack_moments_blocked(
                jnp.asarray(table), jnp.asarray(gmin), jnp.asarray(gmax),
                wshift,
            )
        )
        assert words.shape == (n, 26)
        got = blocked.assemble_moments_packed_blocked(words)
        for k in ("count", "s1", "s2", "cmin", "cmax"):
            np.testing.assert_array_equal(ref[k], got[k]), (k, wshift)


def test_row_cap_moment_combine_bit_identical():
    """The live-row compaction before the segment combine must produce
    identical tables, and count live rows exactly even on overflow."""
    import jax.numpy as jnp

    from tissue_analysis_tpu.ops import blocked

    rng = np.random.default_rng(9)
    B, L, n, C = 50, 8, 40, 10
    ids = rng.integers(0, n, size=(B, L)).astype(np.int32)
    dead = rng.random((B, L)) < 0.6
    ids[dead] = np.int32(2**31 - 1)
    cols = rng.integers(0, 1000, size=(B * L, C)).astype(np.int32)
    cmin = rng.integers(0, 100, size=(B * L, 3)).astype(np.int32)
    cmax = cmin + rng.integers(0, 100, size=(B * L, 3)).astype(np.int32)
    args = tuple(jnp.asarray(a) for a in (ids, cols, cmin, cmax))
    n_live_true = int((~dead).sum())

    ref = blocked._global_moment_combine(*args, n)
    got = blocked._global_moment_combine(
        *args, n, row_cap=(n_live_true // 64 + 2) * 64, return_live=True
    )
    assert int(got[3]) == n_live_true and not bool(got[4])
    for a, b in zip(ref, got[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ovf = blocked._global_moment_combine(
        *args, n, row_cap=64, return_live=True
    )
    assert int(ovf[3]) == n_live_true and bool(ovf[4])
