"""Block-local fused sweep — the scatter-free engine.

Replaces the chunked segment-scatter pipeline (``ops/segred.py`` +
``ops/stencil.py``), whose voxel-scale ``segment_sum`` scatters dominate its
cost. This engine never scatters anything big; it maps the whole problem
onto reshapes, vector compares, matrix contractions, ``top_k`` and small
sorts:

1.  Partition the stack into fixed blocks (default 32³). Per block, extract
    the ≤ L distinct labels by **iterative masked min** (L vector passes, no
    scatter) → per-block dictionary ``ids [B, L]`` (ascending, IMAX-padded).
2.  One-hot ``OH [B, K, L]`` (bf16; 0/1 exact) against the dictionary.
3.  **Moments**: axis-marginals of OH (sum over one block axis) give joint
    (z,y), (z,x), (y,x) histograms per label; contracting them with
    per-block GLOBAL-coordinate weight tables yields count, Σc, Σc·c — all
    exact in int32 via hi/lo weight splitting, then hi/lo row splitting
    before the (tiny,
    B·L-row) global segment-sum, assembled exactly in int64 on the host.
    This yields `volume`, `barycenter`, `boundingbox` (marginal support) and
    the full second-moment matrix for `inertia_axis` in one sweep —
    everything the reference computes in separate `nd.sum` /
    `nd.center_of_mass` / `nd.find_objects` / per-label passes
    (``spatial_image_analysis.py :: volume/center_of_mass/boundingbox/
    inertia_axis``).
4.  **Pairs** (``:: neighbors / cell_wall_surface / wall_surfaces``): for
    each axis, face-adjacency counts are one-hot outer products
    ``OH_aᵀ·OH_b → [B, L, L]`` as batched matmuls (in-block faces), plus seam-plane
    cross-block matmuls (left block dictionary × right block dictionary).
    Count matrices are compacted per block with ``top_k`` (packed
    count·L²+key), mapped to global pair keys, and merged by a device
    sort + segmented-run reduction — no N² keyspace, no scatter.
5.  Margins (``:: cells_in_image_margins``) fall out of the bounding box on
    the host: a label touches an image face iff its bbox does.

All results are exact integers; float conversion happens in
``features/finalize.py`` exactly as for the chunked engine.
"""

from __future__ import annotations

import dataclasses
import math
import os as _os
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BlockConfig", "blocked_sweep", "assemble_moments", "assemble_pairs"]

_IMAX = np.int32(2**31 - 1)
_SPLIT = 15  # row-value hi/lo split; safe while rows-per-segment ≤ 2^16


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    block: Tuple[int, int, int] = (32, 32, 32)
    max_labels_per_block: int = 64  # L
    max_pairs_per_block: int = 256  # kp (per axis, incl. seam groups)
    max_pairs: int = 0  # 0 -> derived from n_labels
    blocks_per_group: int = 0  # 0 -> derived (~2^28 bytes of one-hot live)

    def derived_max_pairs(self, n_labels: int) -> int:
        if self.max_pairs:
            return self.max_pairs
        # ~13.4 edges/cell measured on the 512³ Voronoi stack (SURVEY.md
        # §0.1); 24·N headroom, generous floor for tiny tests
        return max(2048, 24 * n_labels)


def _grid(shape, block):
    return tuple(-(-s // b) for s, b in zip(shape, block))


def _pad_to_blocks(dense: jax.Array, n_labels: int, block) -> jax.Array:
    pads = tuple(
        (0, g * b - s) for s, b, g in zip(dense.shape, block, _grid(dense.shape, block))
    )
    if any(p[1] for p in pads):
        dense = jnp.pad(dense, pads, constant_values=n_labels)
    return dense


def _blockify(dense: jax.Array, block) -> jax.Array:
    """[Z,Y,X] -> [B, bz, by, bx] in (Gz, Gy, Gx) grid-major order."""
    gz, gy, gx = _grid(dense.shape, block)
    bz, by, bx = block
    v = dense.reshape(gz, bz, gy, by, gx, bx)
    v = v.transpose(0, 2, 4, 1, 3, 5)
    return v.reshape(gz * gy * gx, bz, by, bx)


def _block_dicts(vals: jax.Array, L: int):
    """Iterative masked-min unique extraction.

    vals [B, K] int32 -> ids [B, L] int32 ascending, padded with IMAX;
    overflow [B] bool (block had > L distinct labels).
    """
    b, k = vals.shape

    def body(mask, _):
        m = jnp.min(jnp.where(mask, vals, _IMAX), axis=1)  # [B]
        mask = mask & (vals != m[:, None])
        return mask, m

    # vals == vals (always True) instead of jnp.ones: inherits the input's
    # device-varying axes so the scan carry typechecks under shard_map
    mask0 = vals == vals
    mask, ids = jax.lax.scan(body, mask0, None, length=L)
    return ids.T, jnp.any(mask, axis=1)


def _weight_tables(block, offsets_zyx, axes: Tuple[int, int], wshift: int):
    """Global-coordinate weight tables for one marginal plane.

    For the marginal over plane axes (i, j) (block-local sizes bi, bj) the
    features are [1, ci, ci², cj, cj², ci·cj] in GLOBAL coordinates, split
    hi/lo at 2**wshift (coords < 2**wshift, so both parts < 2**wshift and
    the block-level contraction Σ marginal·part ≤ K·2**wshift stays
    int32-exact).
    Returns W [B, bi·bj, 12] int32 (lo/hi interleaved per feature).
    """
    bi, bj = block[axes[0]], block[axes[1]]
    oi = offsets_zyx[axes[0]][:, None, None]  # [B,1,1]
    oj = offsets_zyx[axes[1]][:, None, None]
    ci = jnp.arange(bi, dtype=jnp.int32)[None, :, None] + oi  # [B,bi,1]
    cj = jnp.arange(bj, dtype=jnp.int32)[None, None, :] + oj  # [B,1,bj]
    one = jnp.ones_like(ci + cj)
    feats = [one, ci * one, ci * ci * one, cj * one, cj * cj * one, ci * cj]
    cols = []
    wmask = (1 << wshift) - 1
    for f in feats:
        cols.append(f & wmask)
        cols.append(f >> wshift)
    w = jnp.stack([jnp.broadcast_to(c, ci.shape[:1] + (bi, bj)) for c in cols], -1)
    return w.reshape(w.shape[0], bi * bj, len(cols))


def _split_rows(v: jax.Array) -> jax.Array:
    """Interleave (lo, hi) int32 parts of the last axis at 2**_SPLIT."""
    lo = v & ((1 << _SPLIT) - 1)
    hi = v >> _SPLIT
    return jnp.stack([lo, hi], axis=-1).reshape(*v.shape[:-1], v.shape[-1] * 2)


def _marginal_moments(oh, block, offsets_zyx, wshift):
    """Per-(block, local label) exact global-coordinate moment columns.

    oh: [B, bz, by, bx, L] bf16 one-hot.
    Returns (cols [B, L, C] int32 hi/lo-split rows, bbox (cmin, cmax)
    [B, L, 3] int32 with IMAX/-1 sentinels for absent slots).
    """
    bz, by, bx = block
    bN = oh.shape[0]
    L = oh.shape[-1]

    # marginals: sum over the remaining axis (f32 accumulation is exact:
    # counts ≤ block extent ≤ 2^9 ≪ 2^24), then int32
    m_zy = jnp.sum(oh, axis=3, dtype=jnp.float32).astype(jnp.int32)  # [B,bz,by,L]
    m_zx = jnp.sum(oh, axis=2, dtype=jnp.float32).astype(jnp.int32)  # [B,bz,bx,L]
    m_yx = jnp.sum(oh, axis=1, dtype=jnp.float32).astype(jnp.int32)  # [B,by,bx,L]

    def contract(marg, axes):
        w = _weight_tables(block, offsets_zyx, axes, wshift)
        m2 = marg.reshape(bN, -1, L)
        # [B, P, L]ᵀ·[B, P, C]: per-block Σ marginal·weight, exact int32
        return jax.lax.dot_general(
            m2, w, (((1,), (1,)), ((0,), (0,))), preferred_element_type=jnp.int32
        )  # [B, L, C]

    zy = contract(m_zy, (0, 1))  # count,z,z²,y,y²,zy (lo/hi pairs)
    zx = contract(m_zx, (0, 2))  # count,z,z²,x,x²,zx
    yx = contract(m_yx, (1, 2))  # count,y,y²,x,x²,yx

    # assemble distinct features (lo,hi) per row, weights-merge on host:
    # order: count, Σz, Σz², Σy, Σy², Σzy, Σx, Σx², Σzx, Σyx  (10 features,
    # each as weight-lo and weight-hi int32 columns)
    def fpair(t, i):
        return t[..., 2 * i : 2 * i + 2]

    cols = jnp.concatenate(
        [
            fpair(zy, 0),  # count (hi column is all zero)
            fpair(zy, 1), fpair(zy, 2),  # Σz, Σz²
            fpair(zy, 3), fpair(zy, 4),  # Σy, Σy²
            fpair(zy, 5),  # Σzy
            fpair(zx, 3), fpair(zx, 4),  # Σx, Σx²
            fpair(zx, 5),  # Σzx
            fpair(yx, 5),  # Σyx
        ],
        axis=-1,
    )  # [B, L, 20]
    cols = _split_rows(cols)  # [B, L, 40] safe for ≤2^16-row segment sums

    # bbox from marginal support, global coords
    def support_minmax(marg, axis_len, offset):
        pres = marg > 0  # [B, n, L]
        c = jnp.arange(axis_len, dtype=jnp.int32)[None, :, None] + offset[:, None, None]
        cmin = jnp.min(jnp.where(pres, c, _IMAX), axis=1)
        cmax = jnp.max(jnp.where(pres, c, -1), axis=1)
        return cmin, cmax

    z_supp = jnp.sum(m_zy, axis=2)  # [B,bz,L]
    y_supp = jnp.sum(m_zy, axis=1)  # [B,by,L]
    x_supp = jnp.sum(m_zx, axis=1)  # [B,bx,L]
    mins, maxs = [], []
    for supp, ln, off in (
        (z_supp, bz, offsets_zyx[0]),
        (y_supp, by, offsets_zyx[1]),
        (x_supp, bx, offsets_zyx[2]),
    ):
        mn, mx = support_minmax(supp, ln, off)
        mins.append(mn)
        maxs.append(mx)
    cmin = jnp.stack(mins, axis=-1)  # [B, L, 3]
    cmax = jnp.stack(maxs, axis=-1)
    return cols, cmin, cmax


def _compact_pair_mats(mats, row_ids, col_ids, n_labels, kp):
    """[Bm, L, L] count matrices -> (lo, hi, count [Bm*kp]) via top_k.

    Entries with either id missing/pad (>= n_labels, incl. IMAX) or equal
    ids map to the (lo=hi=IMAX, count=0) sentinel, dropped later. Returns
    also per-matrix overflow (more than kp nonzero entries). Pair identity
    stays as TWO int32 ids — never a packed lo·n+hi key — so the engine has
    no n² keyspace and no label-count ceiling (VERDICT r1 missing #2).
    """
    bm, L, _ = mats.shape
    n = n_labels
    kp = min(kp, L * L)
    flat = mats.reshape(bm, L * L)
    nz = jnp.sum((flat > 0).astype(jnp.int32), axis=1)
    overflow = nz > kp
    nz_max = jnp.max(nz)
    # top_k by count keeps ALL positive entries whenever nz <= kp (zeros
    # pad the rest and are dropped by the validity filter); the returned
    # indices ARE the local pair keys, so no count·L²+key packing pass is
    # needed — tie order among kept entries is irrelevant (the global sort
    # canonicalizes downstream, tables stay bit-identical)
    count, lk = jax.lax.top_k(flat, kp)  # [Bm, kp]
    # local slot -> global id by an integer gather: exact for every id (a
    # float one-hot product would round ids above 2^11 wherever f32
    # matmuls run in TF32); pad slots carry IMAX and fail hi < n below
    ga = jnp.take_along_axis(row_ids, lk // L, axis=1)  # [Bm, kp]
    gb = jnp.take_along_axis(col_ids, lk % L, axis=1)
    lo = jnp.minimum(ga, gb)
    hi = jnp.maximum(ga, gb)
    valid = (count > 0) & (lo != hi) & (hi < n)
    lo = jnp.where(valid, lo, _IMAX)
    hi = jnp.where(valid, hi, _IMAX)
    count = jnp.where(valid, count, 0)
    return lo.reshape(-1), hi.reshape(-1), count.reshape(-1), overflow, nz_max


def _sorted_pair_reduce(
    los, his, tags, counts, max_entries, n_labels=None, unpack=True,
    entry_cap=0, return_live=False,
):
    """Merge (lo, hi, axis, count) entries without scatter.

    Pair identity is the TWO-key tuple (k1 = lo, k2 = hi·4 + axis) — a
    lexicographic 2-key device sort replaces the old packed lo·n+hi key, so
    the only label bound is hi·4+3 ≤ 2³¹ (n ≤ 2²⁹ — no practical ceiling,
    VERDICT r1 missing #2). Sentinel entries carry lo = hi = IMAX.
    Run totals (round 5, `_RUN_TOTAL_MODE="cumdiff"`) are consecutive
    differences of the plain global inclusive cumsum at run ends,
    evaluated after the canonicalization sort — exact under int32
    wraparound whenever each per-(pair, axis) face total is < 2³¹,
    gather-free, and compile-light (the previous segmented-scan
    formulation, kept as the "segscan" mode, measured ~27 min of
    SERVER-SIDE COMPILE alone at 4.47M entries — the round-4 Gvox-wide
    streamed stall, BASELINE.md). A second sort brings run boundaries to
    the front; slice max_entries.

    When ``n_labels`` is given and 4n² fits int32 (n ≤ 23,170 — the common
    case), the two keys pack into ONE int32 key lo·4n + hi·4 + axis with
    the SAME lexicographic order: the sorts move 2 operands instead of 3.
    Larger n takes the two-key path — no label ceiling.
    Returns (k1 [max_entries], k2 [max_entries], total [max_entries], n_runs).

    ``unpack=False`` (packed branch only): skip the device-side unpack and
    return the packed key itself as k1 with k2 = the 1-element marker
    [4·n_labels] — `assemble_pairs` decodes it on the host. One fewer
    [max_entries] int32 array in the device→host readback (~330 KB at the
    512³ bench sizes). Callers that MERGE reduced tables on device (the
    sharded two-stage reduce) need real (k1, k2) and keep the default.

    ``entry_cap`` > 0 (packed branch only): sort the FULL stream once
    (live keys < IMAX order ahead of the sentinel padding), then statically
    slice the first ``entry_cap`` entries — every downstream scan then runs
    over ``entry_cap`` entries instead of 3·B·kp (~85-90% padding at 512³
    with p100-tightened kp). Bit-identical output; a cap overflow
    means live entries were LOST, so the caller must retry larger (the
    engine converges the cap from the measured live count the same way it
    converges kp/max_pairs).

    ``return_live=True`` appends (n_live, cap_overflow) to the return
    tuple — n_live counts the stream's live entries (measured even with
    entry_cap=0 so the engine can set the cap), cap_overflow is False
    when no cap was applied.
    """
    if isinstance(los, (list, tuple)):
        los = jnp.concatenate(los)
        his = jnp.concatenate(his)
        tags = jnp.concatenate(tags)
        counts = jnp.concatenate(counts)
    valid = los < _IMAX
    if n_labels is not None and 4 * n_labels * n_labels < int(_IMAX):
        n4 = 4 * n_labels
        packed = jnp.where(valid, los * n4 + his * 4 + tags, _IMAX)
        cap_ovf = jnp.zeros((), bool)
        presorted = False
        if entry_cap and entry_cap < packed.shape[0]:
            n_live = jnp.sum(valid.astype(jnp.int32))
            cap_ovf = n_live > entry_cap
            packed, counts = jax.lax.sort((packed, counts), num_keys=1)
            packed = packed[:entry_cap]
            counts = counts[:entry_cap]
            presorted = True
        elif return_live:
            n_live = jnp.sum(valid.astype(jnp.int32))
        pk, total, n_runs = _sorted_run_reduce_single(
            packed, counts, max_entries, presorted=presorted
        )
        if not unpack:
            out = (pk, jnp.full((1,), n4, jnp.int32), total, n_runs)
            return out + ((n_live, cap_ovf) if return_live else ())
        live = pk < _IMAX
        k1 = jnp.where(live, pk // n4, _IMAX)
        k2 = jnp.where(live, pk % n4, _IMAX)
        return (k1, k2, total, n_runs) + (
            (n_live, cap_ovf) if return_live else ()
        )
    k2 = jnp.where(valid, his * 4 + tags, _IMAX)
    out = _sorted_pair_reduce_keys(los, k2, counts, max_entries)
    if return_live:
        # two-key path: no cap (the packed-key compaction does not apply),
        # but still measure liveness so the engine's bookkeeping is uniform
        out = out + (jnp.sum(valid.astype(jnp.int32)), jnp.zeros((), bool))
    return out


def _chunked_segsum(counts, starts, chunk=2048):
    """Inclusive SEGMENTED cumsum: running int32 sum of ``counts`` that
    resets wherever ``starts`` (int32 0/1) is 1, via a two-level blocked
    scan — reshape to [G, chunk], `associative_scan` the short lane axis
    with the standard segmented-sum (value, flag) operator, then fold the
    per-row carry (a tiny [G] scan of the same operator) back in.

    Kept as the "segscan" run-total mode (A/B reference for "cumdiff").
    It is strictly safe on exactness: sums accumulate only WITHIN a run,
    so int32 suffices
    whenever each per-(pair, axis) total is < 2³¹ (the existing contract)
    — no reliance on wrap-difference behavior across the whole stream.
    """
    m = counts.shape[0]
    g = -(-m // chunk)
    pad = g * chunk - m
    if pad:
        counts = jnp.concatenate(
            [counts, jnp.zeros((pad,), counts.dtype)]
        )
        starts = jnp.concatenate([starts, jnp.ones((pad,), starts.dtype)])

    def op(a, b):
        asum, aflag = a
        bsum, bflag = b
        return jnp.where(bflag != 0, bsum, asum + bsum), aflag | bflag

    rs, rf = jax.lax.associative_scan(
        op, (counts.reshape(g, chunk), starts.reshape(g, chunk)), axis=1
    )
    csum, cflag = jax.lax.associative_scan(op, (rs[:, -1], rf[:, -1]))
    # carry entering row r = scan state after rows 0..r-1; identity (0, 0)
    # enters row 0. The op is NOT commutative: carry is the LEFT operand.
    csum = jnp.concatenate([jnp.zeros((1,), counts.dtype), csum[:-1]])
    cflag = jnp.concatenate([jnp.zeros((1,), starts.dtype), cflag[:-1]])
    out, _ = op((csum[:, None], cflag[:, None]), (rs, rf))
    out = out.reshape(-1)
    return out[:m] if pad else out


def _take_front(keys_vals, max_entries):
    """First ``max_entries`` rows of an already-sorted (key, *vals) stream,
    padding with (IMAX, 0) when the stream is shorter than the request.

    Compacting a sentinel-masked sorted stream is a plain re-sort + static
    slice: live keys (< IMAX) order ahead of the IMAX sentinels, so the
    prefix IS the compacted table.
    """
    key = keys_vals[0]
    m = key.shape[0]
    if m >= max_entries:
        return tuple(v[:max_entries] for v in keys_vals)
    pad = max_entries - m
    out = [jnp.concatenate([key, jnp.full((pad,), _IMAX, key.dtype)])]
    for v in keys_vals[1:]:
        out.append(jnp.concatenate([v, jnp.zeros((pad,), v.dtype)]))
    return tuple(out)


# run-total mode: "cumdiff" (default) computes each run's total as the
# difference of consecutive run-end values of the PLAIN global inclusive
# cumsum, evaluated after the canonicalization sort — the key-sorted
# stream's run ends appear in ascending key order, so after the second
# sort (live keys ahead of sentinels, ascending) consecutive live rows
# are consecutive runs and total_r = c_end[r] − c_end[r−1]. Exact under
# int32 wraparound (differences are mod-2³² exact while each per-run
# total < 2³¹ — the existing contract), gather-free, and it removes the
# segmented `associative_scan` from the hot path entirely: a multi-million
# entry `_chunked_segsum` compiled pathologically slowly on the toolchain
# it was first built with, while a plain cumsum compiles in seconds.
# "segscan" keeps the old path (A/B reference only).
_RUN_TOTAL_MODE = _os.environ.get("TA_RUN_TOTAL", "cumdiff")


def _run_totals_cumdiff(sort_fn, okeys, c, is_last, max_entries):
    """Shared cumdiff tail: canonicalization-sort ``okeys`` (tuple of key
    operands, sentinels at _IMAX) with the run-end cumsum ``c`` as
    payload, slice, and difference. Returns (*okeys_out, total)."""
    cl = jnp.where(is_last, c, 0)
    out = sort_fn(*okeys, cl)
    out = _take_front(out, max_entries)
    cl = out[-1]
    live = out[0] < _IMAX
    prev = jnp.concatenate([jnp.zeros((1,), cl.dtype), cl[:-1]])
    total = jnp.where(live, cl - prev, 0)
    return out[:-1] + (total,)


def _sorted_run_reduce_single(key, counts, max_entries, presorted=False):
    """Single-int32-key variant of :func:`_sorted_pair_reduce_keys`.

    ``presorted``: the caller already globally sorted (key, counts) — e.g.
    the entry-cap slice in `_sorted_pair_reduce` — so skip the first sort.
    """
    if not presorted:
        key, counts = jax.lax.sort((key, counts), num_keys=1)
    is_last = jnp.concatenate([key[1:] != key[:-1], jnp.array([True])])
    is_last = is_last & (key < _IMAX)
    n_runs = jnp.sum(is_last.astype(jnp.int32))
    okey = jnp.where(is_last, key, _IMAX)
    if _RUN_TOTAL_MODE == "cumdiff":
        c = jnp.cumsum(counts)

        def sort1(k, v):
            return jax.lax.sort((k, v), num_keys=1, is_stable=True)

        okey, total = _run_totals_cumdiff(
            sort1, (okey,), c, is_last, max_entries
        )
        return okey, total, n_runs
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         (key[1:] != key[:-1]).astype(jnp.int32)]
    )
    seg = _chunked_segsum(counts, is_start)  # run totals at run ends
    total = jnp.where(is_last, seg, 0)
    okey = jnp.where(is_last, key, _IMAX)
    okey, total = jax.lax.sort((okey, total), num_keys=1)
    okey, total = _take_front((okey, total), max_entries)
    return okey, total, n_runs


# two-key sort lowering mode: "twopass" (default) lowers the lexicographic
# (k1, k2) sort as two STABLE single-key sorts — at multi-million entries
# a `num_keys=2` comparator sort compiled pathologically slowly on the
# toolchain this engine was first built with, while single-key sorts of
# the same operands compile in seconds. "legacy" keeps the one-pass
# num_keys=2 sort (A/B reference only). Outputs are bit-identical:
# a stable sort by k2 followed by a stable sort by k1 IS the stable
# lexicographic (k1, k2) sort (LSD radix argument), including tie order.
_TWO_KEY_SORT_MODE = _os.environ.get("TA_TWOKEY_SORT", "twopass")


def _lex_sort2(k1, k2, *vals):
    """Stable lexicographic sort by (k1, k2) carrying ``vals`` along."""
    if _TWO_KEY_SORT_MODE == "legacy":
        return jax.lax.sort((k1, k2) + vals, num_keys=2, is_stable=True)
    ops = jax.lax.sort((k2, k1) + vals, num_keys=1, is_stable=True)
    ops = jax.lax.sort((ops[1], ops[0]) + ops[2:], num_keys=1, is_stable=True)
    return ops


def _sorted_pair_reduce_keys(k1, k2, counts, max_entries):
    """Core of :func:`_sorted_pair_reduce` over prebuilt (k1, k2) keys —
    used directly when merging already-reduced per-device entry tables
    (k2 = hi·4 + axis, sentinel k1 = k2 = IMAX)."""
    k1, k2, counts = _lex_sort2(k1, k2, counts)
    diff = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
    is_last = jnp.concatenate([diff, jnp.array([True])])
    is_last = is_last & (k1 < _IMAX)
    n_runs = jnp.sum(is_last.astype(jnp.int32))
    ok1 = jnp.where(is_last, k1, _IMAX)
    ok2 = jnp.where(is_last, k2, _IMAX)
    if _RUN_TOTAL_MODE == "cumdiff":
        c = jnp.cumsum(counts)
        ok1, ok2, total = _run_totals_cumdiff(
            _lex_sort2, (ok1, ok2), c, is_last, max_entries
        )
    else:
        is_start = jnp.concatenate(
            [jnp.ones((1,), jnp.int32), diff.astype(jnp.int32)]
        )
        seg = _chunked_segsum(counts, is_start)  # run totals at run ends
        total = jnp.where(is_last, seg, 0)
        ok1, ok2, total = _lex_sort2(ok1, ok2, total)
        ok1, ok2, total = _take_front((ok1, ok2, total), max_entries)
    ok2 = jnp.where(ok1 < _IMAX, ok2, _IMAX)  # sentinel convention
    return ok1, ok2, total, n_runs


def _face_matmul(a, b, L):
    """[Bm, P, L]ᵀ·[Bm, P, L] face-count matrices: 0/1 bf16 operands are
    exact and per-block counts ≤ 32³ < 2²⁴ stay exact in f32 accumulation."""
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    ).astype(jnp.int32)


def _group_pad(arr, group, pad_value):
    """Pad leading axis to a multiple of `group` and fold into
    [n_groups, group, ...]."""
    bN = arr.shape[0]
    ng = -(-bN // group)
    pad = ng * group - bN
    if pad:
        arr = jnp.concatenate(
            [arr, jnp.full((pad,) + arr.shape[1:], pad_value, arr.dtype)]
        )
    return arr.reshape((ng, group) + arr.shape[1:])


def _seam_slabs(dense, block, axis, tile=None, pad_label=None):
    """Extract seam tiles for one axis: [S, 2, t0, t1] label slabs.

    For axis d with block extent b: planes (k·b-1, k·b), k = 1..g-1, tiled
    by ``tile`` (defaults to the other two block extents; larger tiles mean
    fewer dictionary/compaction rows downstream). Planes are padded to tile
    multiples with ``pad_label`` when needed.
    """
    g = _grid(dense.shape, block)
    b = block[axis]
    take_left = [slice(None)] * 3
    take_left[axis] = slice(b - 1, None, b)
    take_right = [slice(None)] * 3
    take_right[axis] = slice(b, None, b)
    left = dense[tuple(take_left)]
    right = dense[tuple(take_right)]
    ns = g[axis] - 1
    sl = [slice(None)] * 3
    sl[axis] = slice(0, ns)
    left = left[tuple(sl)]
    # move the seam axis first, pair the two planes
    perm = (axis,) + tuple(d for d in range(3) if d != axis)
    left = jnp.transpose(left, perm)  # [ns, S0, S1]
    right = jnp.transpose(right, perm)
    other = [d for d in range(3) if d != axis]
    if tile is None:
        t0, t1 = block[other[0]], block[other[1]]
    else:
        t0, t1 = tile
    pair = jnp.stack([left, right], axis=1)  # [ns, 2, S0, S1]
    s0, s1 = pair.shape[2], pair.shape[3]
    g0, g1 = -(-s0 // t0), -(-s1 // t1)
    if (g0 * t0 != s0) or (g1 * t1 != s1):
        pair = jnp.pad(
            pair,
            ((0, 0), (0, 0), (0, g0 * t0 - s0), (0, g1 * t1 - s1)),
            constant_values=pad_label,
        )
    pair = pair.reshape(ns, 2, g0, t0, g1, t1)
    pair = pair.transpose(0, 2, 4, 1, 3, 5)  # [ns, g0, g1, 2, t0, t1]
    return pair.reshape(ns * g0 * g1, 2, t0, t1)


def _check_static(shape, n_labels, cfg: BlockConfig) -> int:
    """Validate static preconditions; returns wshift for `shape` (the
    GLOBAL padded shape — coordinate exactness is a global property)."""
    block = cfg.block
    L = cfg.max_labels_per_block
    K = math.prod(block)
    n = n_labels
    if n * 4 + 3 > int(_IMAX):
        raise ValueError(
            f"n_labels={n} exceeds the int32 (hi·4 + axis) sort-key space "
            "of the blocked engine (n must be < 2^29)"
        )
    padded = tuple(g * b for g, b in zip(_grid(shape, block), block))
    # coords < 2**wshift; K·2**wshift must stay int32-exact
    wshift = max(int(s - 1).bit_length() for s in padded)
    if K << wshift > int(_IMAX):
        raise ValueError("stack too large for exact int32 block contraction")
    # (no count·L² bound anymore: pair compaction top_k's raw counts and
    # uses the returned indices as local keys — nothing is packed)
    return wshift


def seam_pair_entries(
    dense_padded, block, n, L, kp, group_bytes=1 << 27, tile=None
):
    """Pair entries for every block-seam tile of a (block-padded) stack.

    2-plane seam slabs per axis run through the dictionary + face-matmul
    machinery.
    ``tile`` overrides the seam tile dims (larger tiles ⇒ fewer compaction
    rows; L must still bound the labels per tile — overflow-flagged).
    Returns (los, his, counts, tags, dict_ovf, pair_ovf) — lists per axis.
    """
    bz, by, bx = block
    tile_elems = (
        2 * max(by * bx, bz * bx, bz * by)
        if tile is None
        else 2 * tile[0] * tile[1]
    )
    seam_group_sz = max(1, group_bytes // (tile_elems * L))
    los, his, counts, tags = [], [], [], []
    dovf = jnp.zeros((), bool)
    povf = jnp.zeros((), bool)
    for axis in range(3):
        if _grid(dense_padded.shape, block)[axis] < 2:
            continue
        tiles = _seam_slabs(dense_padded, block, axis, tile=tile, pad_label=n)
        lo, hi, ct, dovf_s, povf_s = seam_tiles_entries(
            tiles, n, L, kp, seam_group_sz
        )
        los.append(lo)
        his.append(hi)
        counts.append(ct)
        tags.append(jnp.full((lo.size,), axis, jnp.int32))
        dovf = dovf | dovf_s
        povf = povf | povf_s
    return los, his, counts, tags, dovf, povf


def seam_tiles_entries(tiles, n, L, kp, group):
    """Pair entries for a batch of 2-plane seam tiles [S, 2, t0, t1]."""

    def seam_body(tiles_grp):
        g_here = tiles_grp.shape[0]
        ks = math.prod(tiles_grp.shape[1:])
        vals = tiles_grp.reshape(g_here, ks)
        ids, dovf = _block_dicts(vals, L)
        oh = (vals[..., None] == ids[:, None, :]).astype(jnp.bfloat16)
        half = ks // 2
        mats = _face_matmul(oh[:, :half, :], oh[:, half:, :], L)
        lo, hi, ct, ov, _nz = _compact_pair_mats(mats, ids, ids, n, kp)
        return lo, hi, ct, dovf.any(), jnp.any(ov)

    tiles_g = _group_pad(tiles, min(group, tiles.shape[0]), n)
    lo, hi, ct, dovf_s, povf_s = jax.lax.map(seam_body, tiles_g)
    return (
        lo.reshape(-1), hi.reshape(-1), ct.reshape(-1),
        jnp.any(dovf_s), jnp.any(povf_s),
    )


def plane_seam_tiles(left_plane, right_plane, tile, pad_label):
    """Two [Y, X] label planes -> seam tiles [S, 2, t0, t1] (tile-padded)."""
    t0, t1 = tile
    y, x = left_plane.shape
    g0, g1 = -(-y // t0), -(-x // t1)
    pair = jnp.stack([left_plane, right_plane], axis=0)  # [2, Y, X]
    if (g0 * t0 != y) or (g1 * t1 != x):
        pair = jnp.pad(
            pair,
            ((0, 0), (0, g0 * t0 - y), (0, g1 * t1 - x)),
            constant_values=pad_label,
        )
    pair = pair.reshape(2, g0, t0, g1, t1).transpose(1, 3, 0, 2, 4)
    return pair.reshape(g0 * g1, 2, t0, t1)


def _build_slab_fns(slab_shape, n_labels, cfg: BlockConfig, wshift: int):
    """Reusable slab-level passes for a static (slab_shape, n_labels, cfg).

    Returns (main, cross_seam):
      main(dense_slab, z_off) -> (ids [Bs, L], cols, cmin, cmax,
                                  los, his, counts, tags, dict_ovf, pair_ovf)
        — the full in-slab pass (moments, bbox, in-block + in-slab seam
        pairs), with all z coordinates offset by the traced scalar z_off.
      cross_seam(left_plane, right_plane) -> (gk, ct, dovf, povf)
        — the pair pass for one z-seam between two [Y, X] label planes
        (used for the slab↔slab halo under sharding).

    Both are organized as `lax.map` over groups of blocks so the one-hot
    tensors (~K·L bytes per block) never exceed ~group·K·L live device
    bytes — ungrouped, the bf16 [B, K, L] one-hot of a 512³ stack at
    L = 64 alone is ~17 GB.
    """
    block = cfg.block
    L = cfg.max_labels_per_block
    kp = cfg.max_pairs_per_block
    gz, gy, gx = _grid(slab_shape, block)
    bz, by, bx = block
    K = bz * by * bx
    bN = gz * gy * gx
    n = n_labels

    # bound on the live bf16 one-hot per lax.map step: 2^28 bytes / (K·L)
    group = cfg.blocks_per_group or max(1, (1 << 28) // (K * L))
    group = min(group, bN)

    # block offsets in grid-major order (slab-local; z_off added at trace)
    ozz, oyy, oxx = np.meshgrid(
        np.arange(gz) * bz, np.arange(gy) * by, np.arange(gx) * bx, indexing="ij"
    )
    offs = np.stack(
        [ozz.reshape(-1), oyy.reshape(-1), oxx.reshape(-1)], axis=1
    ).astype(np.int32)

    def main_group(args):
        vb, off = args  # [G, bz, by, bx], [G, 3]
        g_here = vb.shape[0]
        vals = vb.reshape(g_here, K)
        ids, dovf = _block_dicts(vals, L)
        oh = (vb[..., None] == ids[:, None, None, None, :]).astype(jnp.bfloat16)
        cols, cmin, cmax = _marginal_moments(
            oh, block, (off[:, 0], off[:, 1], off[:, 2]), wshift
        )
        glos, ghis, cts, tgs = [], [], [], []
        povf = jnp.zeros((), dtype=bool)
        slicers = [
            (lambda t: t[:, :-1], lambda t: t[:, 1:]),  # z
            (lambda t: t[:, :, :-1], lambda t: t[:, :, 1:]),  # y
            (lambda t: t[:, :, :, :-1], lambda t: t[:, :, :, 1:]),  # x
        ]
        for ax, (sa, sb) in enumerate(slicers):
            a = sa(oh).reshape(g_here, -1, L)
            b = sb(oh).reshape(g_here, -1, L)
            mats = _face_matmul(a, b, L)
            lo, hi, ct, ov, _nz = _compact_pair_mats(mats, ids, ids, n, kp)
            glos.append(lo)
            ghis.append(hi)
            cts.append(ct)
            tgs.append(jnp.full(lo.shape, ax, jnp.int32))
            povf = povf | jnp.any(ov)
        return (
            ids, cols, cmin, cmax,
            jnp.concatenate(glos), jnp.concatenate(ghis),
            jnp.concatenate(cts), jnp.concatenate(tgs),
            dovf.any(), povf,
        )

    def seam_body(args):
        tiles = args  # [G, 2, t0, t1]
        g_here = tiles.shape[0]
        ks = math.prod(tiles.shape[1:])
        vals = tiles.reshape(g_here, ks)
        ids, dovf = _block_dicts(vals, L)
        oh = (vals[..., None] == ids[:, None, :]).astype(jnp.bfloat16)
        half = ks // 2
        mats = _face_matmul(oh[:, :half, :], oh[:, half:, :], L)
        lo, hi, ct, ov, _nz = _compact_pair_mats(mats, ids, ids, n, kp)
        return lo, hi, ct, dovf.any(), jnp.any(ov)

    # same bound for the 2-plane seam tiles: 2^27 bytes of live one-hot
    seam_group_sz = max(1, (1 << 27) // (2 * max(by * bx, bz * bx, bz * by) * L))

    def run_seam_tiles(tiles, axis, sinks):
        los, his, counts, tags, flags = sinks
        s_here = tiles.shape[0]
        tiles_g = _group_pad(tiles, min(seam_group_sz, s_here), n)
        lo, hi, ct, dovf_s, povf_s = jax.lax.map(seam_body, tiles_g)
        los.append(lo.reshape(-1))
        his.append(hi.reshape(-1))
        counts.append(ct.reshape(-1))
        tags.append(jnp.full((lo.size,), axis, jnp.int32))
        flags.append((jnp.any(dovf_s), jnp.any(povf_s)))

    def main(dense_slab, z_off):
        dense_slab = _pad_to_blocks(dense_slab.astype(jnp.int32), n, block)
        vb_all = _group_pad(_blockify(dense_slab, block), group, n)
        off = jnp.asarray(offs).at[:, 0].add(jnp.asarray(z_off, jnp.int32))
        off_all = _group_pad(off, group, 0)

        ids, cols, cmin, cmax, lo0, hi0, ct0, tg0, dovf, povf = jax.lax.map(
            main_group, (vb_all, off_all)
        )
        nb_pad = ids.shape[0] * ids.shape[1]
        los = [lo0.reshape(-1)]
        his = [hi0.reshape(-1)]
        counts = [ct0.reshape(-1)]
        tags = [tg0.reshape(-1)]
        flags = [(jnp.any(dovf), jnp.any(povf))]
        sinks = (los, his, counts, tags, flags)

        # in-slab seam passes: 2-plane slabs, same dictionary machinery
        for axis in range(3):
            if _grid(dense_slab.shape, block)[axis] < 2:
                continue
            run_seam_tiles(_seam_slabs(dense_slab, block, axis), axis, sinks)

        dict_overflow = jnp.zeros((), bool)
        pair_overflow = jnp.zeros((), bool)
        for d, p in flags:
            dict_overflow = dict_overflow | d
            pair_overflow = pair_overflow | p
        return (
            ids.reshape(nb_pad, L),
            cols.reshape(nb_pad * L, -1),
            cmin.reshape(nb_pad * L, 3),
            cmax.reshape(nb_pad * L, 3),
            jnp.concatenate(los),
            jnp.concatenate(his),
            jnp.concatenate(counts),
            jnp.concatenate(tags),
            dict_overflow,
            pair_overflow,
        )

    def cross_seam(left_plane, right_plane):
        """z-seam between two [Y, X] planes (already y/x block-padded)."""
        y, x = left_plane.shape
        gy2, gx2 = y // by, x // bx
        pair = jnp.stack([left_plane, right_plane], axis=0)  # [2, Y, X]
        pair = pair.reshape(2, gy2, by, gx2, bx).transpose(1, 3, 0, 2, 4)
        tiles = pair.reshape(gy2 * gx2, 2, by, bx)
        sinks = ([], [], [], [], [])
        run_seam_tiles(tiles, 0, sinks)
        los, his, counts, tags, flags = sinks
        return los[0], his[0], counts[0], flags[0][0], flags[0][1]

    return main, cross_seam


def _global_moment_combine(ids, cols, cmin, cmax, n, row_cap=0,
                           return_live=False):
    """Segment-combine per-(block, slot) rows into per-label tables.

    The only scatter in the engine — over B·L rows, not voxels.

    ``row_cap`` > 0: compact the LIVE rows (ids < IMAX — typically ~1/3 of
    the B·L slots at the default L) to the front first, so the
    segment-sum scatter runs over row_cap rows instead of B·L.
    ``return_live=True`` appends (n_rows_live, row_overflow) to the
    return tuple — overflow means rows were dropped (results incomplete,
    caller must retry larger; the engine converges row_cap from the
    measured live count, which is exact even on overflow)."""
    seg = jnp.where(ids == _IMAX, n, ids).reshape(-1)
    if row_cap and row_cap < seg.shape[0]:
        m = seg.shape[0]
        idx = jnp.arange(m, dtype=jnp.int32)
        # full sort of the two NARROW operands (seg, row index) orders the
        # live rows (seg < n) ahead of the dead slots, so the row_cap
        # prefix IS the compacted index list; the wide column block is
        # never co-sorted, only row-gathered once below
        sk, si = jax.lax.sort((seg, idx), num_keys=1)
        n_rows_live = jnp.sum((seg < n).astype(jnp.int32))
        i = jnp.arange(row_cap, dtype=jnp.int32)
        valid = i < n_rows_live
        rows = jnp.where(valid, si[:row_cap], 0)
        seg_c = jnp.where(valid, sk[:row_cap], n)
        cols_c = jnp.take(cols.reshape(m, -1), rows, axis=0)
        cmin_c = jnp.take(cmin.reshape(m, -1), rows, axis=0)
        cmax_c = jnp.take(cmax.reshape(m, -1), rows, axis=0)
        # dead gather rows (valid=False) carry seg n and drop out of [:n];
        # cmin/cmax sentinels don't matter for them
        table = jax.ops.segment_sum(
            jnp.where(valid[:, None], cols_c, 0), seg_c, num_segments=n + 1
        )[:n]
        gmin = jax.ops.segment_min(
            jnp.where(valid[:, None], cmin_c, _IMAX), seg_c,
            num_segments=n + 1,
        )[:n]
        gmax = jax.ops.segment_max(
            jnp.where(valid[:, None], cmax_c, -1), seg_c, num_segments=n + 1
        )[:n]
        if return_live:
            return table, gmin, gmax, n_rows_live, n_rows_live > row_cap
        return table, gmin, gmax
    table = jax.ops.segment_sum(cols, seg, num_segments=n + 1)[:n]
    gmin = jax.ops.segment_min(cmin, seg, num_segments=n + 1)[:n]
    gmax = jax.ops.segment_max(cmax, seg, num_segments=n + 1)[:n]
    if return_live:
        live_rows = jnp.sum((seg < n).astype(jnp.int32))
        return table, gmin, gmax, live_rows, jnp.zeros((), bool)
    return table, gmin, gmax


def _pack_value_words(table, specs):
    """Generic device-side base-2³² packing of split-column 64-bit values.

    ``table``: [N, C] int32 of (lo, hi)-interleaved split columns — column
    pair c holds value-piece = table[:, 2c] + (table[:, 2c+1] << _SPLIT).
    ``specs``: one list per output value of (pair-index c, shift q) — the
    value is Σ piece_c << q. Returns (lo_words, hi_words) lists of [N]
    int32 with value = uint32(lo) + (hi << 32).

    Pure elementwise int32 VPU math via four base-2¹⁶ limbs; carries
    beyond limb 3 are provably zero while every contribution is
    nonnegative and the true value is < 2⁶¹ (callers' static bounds).
    """
    mask16 = jnp.int32(0xFFFF)
    los, his = [], []
    for spec in specs:
        w = [jnp.zeros_like(table[:, 0]) for _ in range(4)]
        for c, q in spec:
            # split interleave is at 2^_SPLIT (= 15), NOT 16
            for col, s in (
                (table[:, 2 * c], q), (table[:, 2 * c + 1], q + _SPLIT)
            ):
                for part, sh in ((col & mask16, s), (col >> 16, s + 16)):
                    a, b = divmod(sh, 16)
                    t = part << b  # part < 2^16, b <= 15: fits int32
                    w[a] = w[a] + (t & mask16)
                    if a + 1 < 4:
                        w[a + 1] = w[a + 1] + (t >> 16)
                    # else: carry provably zero (value < 2^61)
        w[1] = w[1] + (w[0] >> 16)
        w[2] = w[2] + (w[1] >> 16)
        w[3] = w[3] + (w[2] >> 16)
        los.append((w[0] & mask16) | ((w[1] & mask16) << 16))
        his.append((w[2] & mask16) | ((w[3] & mask16) << 16))
    return los, his


def pack_moments_blocked(table, gmin, gmax, wshift):
    """Device-side base-2³² packing of the blocked moment table.

    ``table``: [N, 40] int32 — 10 features × (weight-lo, weight-hi) ×
    (row-lo, row-hi); feature f's 64-bit value = (table[:, 4f] +
    (table[:, 4f+1] << _SPLIT)) + (table[:, 4f+2] + (table[:, 4f+3] <<
    _SPLIT)) << wshift. Output [N, 26]: value lo-words 10 | hi-words 10 |
    gmin 3 | gmax 3 — a 46 → 26 column readback (at 262,144 labels the
    unpacked [n, 46] table alone is ~48 MB). Bound: values <
    2⁶¹ whenever count·(extent−1)² < 2⁶¹ — every HBM-resident stack.
    """
    specs = [[(2 * f, 0), (2 * f + 1, wshift)] for f in range(10)]
    los, his = _pack_value_words(table, specs)
    return jnp.concatenate(
        [jnp.stack(los, axis=1), jnp.stack(his, axis=1), gmin, gmax], axis=1
    )


def assemble_moments_packed_blocked(words: np.ndarray) -> Dict[str, np.ndarray]:
    """Host decode of :func:`pack_moments_blocked` — same dict contract as
    :func:`assemble_moments` (count, s1 [N,3], s2 [N,6] in tri_pairs
    order zz, zy, zx, yy, yx, xx, cmin/cmax [N,3])."""
    w = np.asarray(words, np.int32)
    lo = w[:, :10].astype(np.uint32).astype(np.int64)
    hi = w[:, 10:20].astype(np.uint32).astype(np.int64)
    f = lo + (hi << 32)
    count, sz, szz, sy, syy, szy, sx, sxx, szx, syx = (
        f[:, i] for i in range(10)
    )
    s1 = np.stack([sz, sy, sx], axis=1)
    s2 = np.stack([szz, szy, szx, syy, syx, sxx], axis=1)
    cmin = w[:, 20:23].astype(np.int64)
    cmax = w[:, 23:26].astype(np.int64)
    empty = count == 0
    cmin[empty] = 0
    cmax[empty] = 0
    return {"count": count, "s1": s1, "s2": s2, "cmin": cmin, "cmax": cmax}


def _build_sweep(shape, n_labels, cfg: BlockConfig):
    """Single-device jitted sweep for a static (shape, n_labels, cfg)."""
    n = n_labels
    wshift = _check_static(shape, n, cfg)
    main, _ = _build_slab_fns(shape, n, cfg, wshift)
    max_entries = 3 * cfg.derived_max_pairs(n)

    def sweep(dense):
        ids, cols, cmin, cmax, los, his, counts, tags, dovf, povf = main(dense, 0)
        table, gmin, gmax = _global_moment_combine(ids, cols, cmin, cmax, n)
        # base-2^32 device packing: [n, 46] -> [n, 26] readback columns
        mom = pack_moments_blocked(table, gmin, gmax, wshift)
        k1, k2, total, n_runs = _sorted_pair_reduce(
            los, his, tags, counts, max_entries, n_labels=n, unpack=False
        )
        return mom, k1, k2, total, n_runs, dovf, povf

    return jax.jit(sweep), wshift


_SWEEP_CACHE: Dict[Tuple, any] = {}


def blocked_sweep(dense: jax.Array, n_labels: int, cfg: Optional[BlockConfig] = None):
    """Run the blocked sweep. Returns (device outputs tuple, wshift)."""
    cfg = cfg or BlockConfig()
    key = (tuple(dense.shape), n_labels, cfg)
    entry = _SWEEP_CACHE.get(key)
    if entry is None:
        entry = _build_sweep(tuple(dense.shape), n_labels, cfg)
        _SWEEP_CACHE[key] = entry
    fn, wshift = entry
    return fn(dense), wshift


def assemble_moments(
    table: np.ndarray, gmin: np.ndarray, gmax: np.ndarray, wshift: int
) -> Dict[str, np.ndarray]:
    """Host-side exact int64 assembly of the split moment columns.

    table: [N, 40] int32 — 10 features × (weight-lo, weight-hi) × (row-lo,
    row-hi); feature order: count, Σz, Σz², Σy, Σy², Σzy, Σx, Σx², Σzx, Σyx.
    Returns dict in the same layout as `segred.combine_moment_partials`:
    count, s1 [N,3], s2 [N,6] (order zz, zy, zx, yy, yx, xx — see
    `features.finalize.tri_pairs`), cmin/cmax [N,3].
    """
    t = table.astype(np.int64)
    feats = []
    for f in range(10):
        wlo_lo = t[:, 4 * f + 0]
        wlo_hi = t[:, 4 * f + 1]
        whi_lo = t[:, 4 * f + 2]
        whi_hi = t[:, 4 * f + 3]
        wlo = wlo_lo + (wlo_hi << _SPLIT)
        whi = whi_lo + (whi_hi << _SPLIT)
        feats.append(wlo + (whi << wshift))
    count, sz, szz, sy, syy, szy, sx, sxx, szx, syx = feats
    s1 = np.stack([sz, sy, sx], axis=1)
    s2 = np.stack([szz, szy, szx, syy, syx, sxx], axis=1)
    cmin = gmin.astype(np.int64)
    cmax = gmax.astype(np.int64)
    empty = count == 0
    cmin[empty] = 0
    cmax[empty] = 0
    return {"count": count, "s1": s1, "s2": s2, "cmin": cmin, "cmax": cmax}


def assemble_pairs(
    k1: np.ndarray, k2: np.ndarray, total: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted k1=lo, k2=hi·4+axis, totals) -> pair_lo, pair_hi, per-axis
    face counts. Sentinel entries carry k1 = IMAX and are dropped. Host
    combine uses int64 packed keys — no label-count ceiling.

    Packed readback form (`_sorted_pair_reduce(..., unpack=False)`): k1 is
    the single packed key lo·4n + hi·4 + axis and k2 is the 1-element
    marker [4n] — decoded here; the pair order (ascending lo, hi) is
    unchanged, so results are bit-identical to the unpacked form.
    """
    k1 = np.asarray(k1)
    k2 = np.asarray(k2)
    total = np.asarray(total)
    valid = k1 < int(_IMAX)
    if k2.shape[0] == 1 and k1.shape[0] != 1:
        n4 = np.int64(k2[0])
        pk = k1[valid].astype(np.int64)
        lo = pk // n4
        rest = pk % n4
    else:
        lo = k1[valid].astype(np.int64)
        rest = k2[valid].astype(np.int64)
    hi = rest >> 2
    ax = rest & 3
    # pair order = ascending (lo, hi), matching the device sort
    gk = (lo << 32) | hi
    tot = total[valid].astype(np.int64)
    # The device reduce emits ONE row per (lo, hi, axis), already sorted —
    # when that holds (strictly increasing (gk, ax)), run boundaries come
    # from a diff and the per-axis fill is a direct assignment: no
    # O(m log m) np.unique re-sort and no buffered np.add.at scatter
    # (~2 ms -> ~0.3 ms at the 512³ bench's 42k rows; the gap widens with
    # label count). Host-side multi-slab merges may carry duplicates and
    # take the general branch below.
    m = gk.shape[0]
    strict = m == 0 or bool(
        np.all((gk[1:] > gk[:-1]) | ((gk[1:] == gk[:-1]) & (ax[1:] > ax[:-1])))
    )
    if strict:
        starts = np.empty(m, dtype=bool)
        if m:
            starts[0] = True
            np.not_equal(gk[1:], gk[:-1], out=starts[1:])
        inv = np.cumsum(starts) - 1
        uniq = gk[starts]
        counts3 = np.zeros((uniq.shape[0], 3), dtype=np.int64)
        counts3[inv, ax] = tot
    else:
        uniq, inv = np.unique(gk, return_inverse=True)
        counts3 = np.zeros((uniq.shape[0], 3), dtype=np.int64)
        np.add.at(counts3, (inv, ax), tot)
    return (
        (uniq >> 32).astype(np.int32),
        (uniq & 0xFFFFFFFF).astype(np.int32),
        counts3,
    )
