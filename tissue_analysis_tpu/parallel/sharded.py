"""Multi-device z-slab sharding of the fused analysis pipeline.

SURVEY.md §2.3 / §5 "long-context analogue": the rebuild's sequence axis is
the z-axis of the voxel stack. Design (all XLA collectives — no custom
transport):

- the stack is sharded as contiguous z-slabs over a ``('z',)`` mesh axis
  (``shard_map``, in_spec ``P('z')``);
- the **moment sweep** needs no halo at all: slabs are contiguous in flat
  order, so each device runs the exact same chunked kernel
  (:func:`ops.segred.moment_chunks`) at its global flat offset and the
  per-chunk partial tables concatenate along the chunk axis (out_spec
  ``P('z')``) — bit-identical to the single-device sweep;
- the **stencil sweep** needs a ONE-voxel halo only for the z axis: each
  device `ppermute`s its first z-plane to the previous device (the ring-halo
  exchange), which then counts the seam faces — "lower-z owner wins"
  dedup. Pair-count tables merge with `psum`; compaction runs replicated;
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.features.table import FeatureTable
from tissue_analysis_tpu.ops import blocked, segred, stencil

__all__ = [
    "make_mesh",
    "sharded_pipeline",
    "analyze_sharded",
    "analyze_sharded_blocked",
    "analyze_sharded_chunked",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "z") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _two_stage_pair_reduce(los, his, tags, counts, max_entries, n_labels=None):
    """Sharded pair merge: reduce locally FIRST, then all_gather only the
    per-device run tables and merge those (VERDICT r1 weak #2: the old
    all_gather-then-reduce replicated an O(total_entries·log) sort on every
    device; this gathers ≤ max_entries rows per device instead).

    Each device's distinct (pair, axis) runs are a subset of the global
    runs, so the local stage uses the same max_entries bound; a local slice
    overflow is surfaced through the returned n_runs (pmax over devices) so
    the host rerun-larger loop still fires. Bit-identical to the
    single-stage reduce.
    """
    lk1, lk2, ltot, ln_runs = blocked._sorted_pair_reduce(
        los, his, tags, counts, max_entries, n_labels=n_labels
    )
    gk1 = jax.lax.all_gather(lk1, "z", tiled=True)
    gk2 = jax.lax.all_gather(lk2, "z", tiled=True)
    gtot = jax.lax.all_gather(ltot, "z", tiled=True)
    k1, k2, total, n_runs = blocked._sorted_pair_reduce_keys(
        gk1, gk2, gtot, max_entries
    )
    n_runs = jnp.maximum(n_runs, jax.lax.pmax(ln_runs, "z"))
    return k1, k2, total, n_runs


def _slab_kernel(slab, *, n_labels, shape, orig_z, chunk, max_pairs, n_dev):
    """Per-device body under shard_map. ``slab``: int32 [Z/n, Y, X].

    ``shape`` is the PADDED global shape (coordinate/flat-offset basis);
    ``orig_z`` the unpadded z extent (margin semantics use the real faces).
    """
    n = n_labels
    me = jax.lax.axis_index("z")
    slab_voxels = math.prod(slab.shape)

    # ---- moments: same kernel as single-device, at the global flat offset
    flat = segred.pad_flat(slab, n, chunk)
    tables, cmin, cmax = segred.moment_chunks(
        flat, me * slab_voxels, shape, n, chunk
    )

    # ---- stencil: in-slab (k1, k2) key streams for every axis; z seam via
    # ring halo (pad planes carry the label n, masked by the streams)
    axes_offs = tuple(
        tuple(1 if d == a else 0 for d in range(slab.ndim))
        for a in range(slab.ndim)
    )
    k1, k2 = stencil.pair_key_streams(
        slab, n, axes_offs, tuple(range(slab.ndim))
    )
    # seam: receive the NEXT slab's first z-plane; count faces against my
    # last plane (devices 0..n_dev-2 own their upper seam)
    from_next = jax.lax.ppermute(
        slab[0], "z", perm=[(i, i - 1) for i in range(1, n_dev)]
    )
    a = slab[-1].reshape(-1)
    b = from_next.reshape(-1)
    svalid = (me < n_dev - 1) & (a != b) & (a < n) & (b < n)
    k1 = jnp.concatenate(
        [k1, jnp.where(svalid, jnp.minimum(a, b), blocked._IMAX)]
    )
    k2 = jnp.concatenate(
        [k2, jnp.where(svalid, jnp.maximum(a, b) * 4, blocked._IMAX)]
    )

    # local chunked reduce, then merge only the per-device run tables
    f1, f2, ft, ln_runs, chunk_ovf = stencil.chunked_key_reduce(
        k1, k2, chunk, 3 * max_pairs, 3 * max_pairs
    )
    g1 = jax.lax.all_gather(f1, "z", tiled=True)
    g2 = jax.lax.all_gather(f2, "z", tiled=True)
    gt = jax.lax.all_gather(ft, "z", tiled=True)
    F1, F2, FT, n_runs = blocked._sorted_pair_reduce_keys(
        g1, g2, gt, 3 * max_pairs
    )
    n_runs = jnp.maximum(n_runs, jax.lax.pmax(ln_runs, "z"))
    chunk_ovf = jax.lax.psum(chunk_ovf.astype(jnp.int32), "z") > 0

    pair_lo, pair_hi, counts, n_pairs = stencil.compact_runs_to_coo(
        F1, F2, FT, max_pairs, slab.ndim
    )
    overflowed = chunk_ovf | (n_runs > 3 * max_pairs) | (n_pairs > max_pairs)
    n_pairs = jnp.where(
        overflowed, jnp.maximum(n_pairs, 2 * max_pairs), n_pairs
    )

    # ---- margins: y/x boundary planes on every slab; z boundaries are the
    # REAL global faces (plane 0 on device 0; plane orig_z-1 wherever it
    # lives — with z padding the last slabs may be entirely pad)
    slab_z = slab.shape[0]
    loc_last = (orig_z - 1) - me * slab_z
    has_last = (loc_last >= 0) & (loc_last < slab_z)
    plane_last = jax.lax.dynamic_index_in_dim(
        slab, jnp.clip(loc_last, 0, slab_z - 1), axis=0, keepdims=False
    )
    planes = [
        jnp.where(me == 0, slab[0], n).reshape(-1),
        jnp.where(has_last, plane_last, n).reshape(-1),
    ]
    for d in range(1, slab.ndim):
        planes.append(jax.lax.index_in_dim(slab, 0, axis=d).reshape(-1))
        planes.append(
            jax.lax.index_in_dim(slab, slab.shape[d] - 1, axis=d).reshape(-1)
        )
    boundary = jnp.concatenate(planes)
    # segment_sum, NOT segment_max: segment_max fills absent segments with
    # INT32_MIN, and psum-ing those across devices wraps int32 into garbage
    present = jax.ops.segment_sum(
        jnp.ones_like(boundary), boundary, num_segments=n + 1
    )[:n]
    margin = jax.lax.psum(present, "z") > 0

    return tables, cmin, cmax, pair_lo, pair_hi, counts, n_pairs, margin


@partial(
    jax.jit,
    static_argnames=("n_labels", "chunk", "max_pairs", "mesh", "orig_z"),
)
def sharded_pipeline(dense, n_labels, chunk, max_pairs, mesh, orig_z):
    """Full fused pipeline over a z-sharded stack (already z-padded to a
    multiple of the mesh size — padding must happen before `device_put`, an
    uneven z-shard is rejected). ``orig_z`` is the unpadded z extent (margin
    semantics use the real faces). Returns the same partial tables as the
    single-device path (chunk axis concatenated over devices).
    """
    n_dev = mesh.shape["z"]
    if dense.shape[0] % n_dev:
        raise ValueError("z extent must be padded to a multiple of mesh size")
    # IMPORTANT: coordinates are derived from the PADDED shape so flat
    # offsets per slab are right; pad voxels land in the dropped segment.
    shape = tuple(dense.shape)

    kernel = partial(
        _slab_kernel,
        n_labels=n_labels,
        shape=shape,
        orig_z=orig_z,
        chunk=chunk,
        max_pairs=max_pairs,
        n_dev=n_dev,
    )
    spec_in = P("z", *(None,) * (dense.ndim - 1))
    fn = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=spec_in,
        out_specs=(P("z"), P("z"), P("z"), P(), P(), P(), P(), P()),
        # the final pair merge runs replicated on all_gathered run tables;
        # identical on every device but not provable by the vma checker
        check_vma=False,
    )
    return fn(dense)


def analyze_sharded(
    stack: LabeledStack,
    mesh: Optional[Mesh] = None,
    max_pairs: Optional[int] = None,
    chunk: Optional[int] = None,
    engine: str = "auto",
) -> FeatureTable:
    """Multi-device equivalent of :func:`engine.analyze_stack` — identical
    outputs (bit-for-bit) with z-slab sharding over the mesh.

    engine='auto' / 'blocked': the blocked slab pass for 3D stacks (2D
    images and failed blocked preconditions take the chunked engine);
    engine='chunked': the chunked slab pass.
    """
    from tissue_analysis_tpu.engine import check_engine

    check_engine(engine)
    if engine != "chunked" and stack.ndim == 3:
        try:
            return analyze_sharded_blocked(stack, mesh=mesh)
        except ValueError:
            pass
    return analyze_sharded_chunked(stack, mesh=mesh, max_pairs=max_pairs, chunk=chunk)


# ---------------------------------------------------------------------------
# Blocked (scatter-free) engine under z-slab sharding
# ---------------------------------------------------------------------------


def _blocked_slab_kernel(slab, *, n, cfg, wshift, slab_z, n_dev, max_entries):
    """Per-device body: in-slab blocked pass + ring-halo cross seam.

    The z-seam between consecutive slabs is the sharded analogue of the
    in-slab seam pass: each device `ppermute`s its FIRST z-plane to the
    previous device, which runs the 2-plane seam-tile pass against its own
    last plane ("lower-z owner wins", SURVEY.md §5). Moment tables merge
    with `psum`/`pmin`/`pmax`; pair entries `all_gather` into the same
    sort-reduce as the single-device path — results are bit-identical.
    """
    main, cross_seam = blocked._build_slab_fns(slab.shape, n, cfg, wshift)
    me = jax.lax.axis_index("z")
    ids, cols, cmin, cmax, los, his, counts, tags, dovf, povf = main(
        slab, me * slab_z
    )

    # cross-slab seam (y/x padded to block multiples, pad label n)
    by, bx = cfg.block[1], cfg.block[2]
    y, x = slab.shape[1], slab.shape[2]
    yp, xp = -(-y // by) * by, -(-x // bx) * bx
    first = jnp.pad(
        slab[0].astype(jnp.int32),
        ((0, yp - y), (0, xp - x)),
        constant_values=n,
    )
    last = jnp.pad(
        slab[-1].astype(jnp.int32),
        ((0, yp - y), (0, xp - x)),
        constant_values=n,
    )
    if n_dev > 1:
        recv = jax.lax.ppermute(
            first, "z", perm=[(i, i - 1) for i in range(1, n_dev)]
        )
        recv = jnp.where(me < n_dev - 1, recv, n)
        lo_s, hi_s, ct_s, dovf_s, povf_s = cross_seam(last, recv)
        los = jnp.concatenate([los, lo_s])
        his = jnp.concatenate([his, hi_s])
        counts = jnp.concatenate([counts, ct_s])
        tags = jnp.concatenate([tags, jnp.zeros(lo_s.shape, jnp.int32)])
        dovf = dovf | dovf_s
        povf = povf | povf_s

    table_l, gmin_l, gmax_l = blocked._global_moment_combine(
        ids, cols, cmin, cmax, n
    )
    table = jax.lax.psum(table_l, "z")
    gmin = jax.lax.pmin(gmin_l, "z")
    gmax = jax.lax.pmax(gmax_l, "z")

    k1, k2, total, n_runs = _two_stage_pair_reduce(
        los, his, tags, counts, max_entries, n_labels=n
    )
    flags = jax.lax.psum(
        jnp.stack([dovf, povf]).astype(jnp.int32), "z"
    )
    return table, gmin, gmax, k1, k2, total, n_runs, flags[0] > 0, flags[1] > 0


@partial(
    jax.jit, static_argnames=("n", "cfg", "wshift", "slab_z", "mesh", "max_entries")
)
def _blocked_sharded_pipeline(dense, n, cfg, wshift, slab_z, mesh, max_entries):
    n_dev = mesh.shape["z"]
    kernel = partial(
        _blocked_slab_kernel,
        n=n,
        cfg=cfg,
        wshift=wshift,
        slab_z=slab_z,
        n_dev=n_dev,
        max_entries=max_entries,
    )
    fn = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=P("z", None, None),
        out_specs=(P(),) * 9,
        # the pair sort-reduce runs replicated on all_gathered inputs;
        # identical on every device but not provable by the vma checker
        check_vma=False,
    )
    return fn(dense)


def analyze_sharded_blocked(
    stack: LabeledStack,
    mesh: Optional[Mesh] = None,
    cfg: Optional[blocked.BlockConfig] = None,
) -> FeatureTable:
    """z-slab-sharded blocked engine; bit-identical to
    :func:`engine.analyze_stack_blocked`."""
    import dataclasses

    if mesh is None:
        mesh = make_mesh()
    if stack.ndim != 3:
        raise ValueError("blocked sharded engine requires a 3D stack")
    n = stack.n_labels
    n_dev = mesh.shape["z"]
    from tissue_analysis_tpu.engine import _GOOD_CFG

    cfg_key = (
        ("sharded-blocked", stack.shape, n, n_dev) if cfg is None else None
    )
    if cfg is None:
        cfg = _GOOD_CFG.get(cfg_key) or blocked.BlockConfig()
    bz = cfg.block[0]
    z = stack.shape[0]
    slab_z = -(-z // (n_dev * bz)) * bz
    zp = slab_z * n_dev
    padded_global = (
        (zp,)
        + tuple(-(-s // b) * b for s, b in zip(stack.shape[1:], cfg.block[1:]))
    )
    wshift = blocked._check_static(padded_global, n, cfg)

    # uint16 kept through device_put when it fits; upcast happens on device
    dense = stack.dense
    if zp != z:
        dense = jnp.pad(dense, ((0, zp - z), (0, 0), (0, 0)), constant_values=n)
    dense = jax.device_put(dense, NamedSharding(mesh, P("z", None, None)))

    for _attempt in range(12):
        max_entries = 3 * cfg.derived_max_pairs(n)
        table, gmin, gmax, k1, k2, total, n_runs, dovf, povf = (
            _blocked_sharded_pipeline(
                dense, n, cfg, wshift, slab_z, mesh, max_entries
            )
        )
        if bool(dovf):
            cfg = dataclasses.replace(
                cfg, max_labels_per_block=cfg.max_labels_per_block * 4
            )
            continue
        if bool(povf):
            cfg = dataclasses.replace(
                cfg, max_pairs_per_block=cfg.max_pairs_per_block * 4
            )
            continue
        if int(n_runs) > max_entries:
            cfg = dataclasses.replace(cfg, max_pairs=-(-int(n_runs) // 3) + 16)
            continue
        if cfg_key is not None:
            _GOOD_CFG[cfg_key] = cfg
        moments = blocked.assemble_moments(
            np.asarray(table), np.asarray(gmin), np.asarray(gmax), wshift
        )
        pair_lo, pair_hi, counts3 = blocked.assemble_pairs(
            np.asarray(k1), np.asarray(k2), np.asarray(total)
        )
        from tissue_analysis_tpu.engine import _margin_from_bbox

        return FeatureTable(
            ids=stack.ids.copy(),
            shape=stack.shape,
            voxelsize=stack.voxelsize,
            background_segment=stack.background_segment,
            count=moments["count"],
            s1=moments["s1"],
            s2=moments["s2"],
            cmin=moments["cmin"],
            cmax=moments["cmax"],
            pair_lo=pair_lo,
            pair_hi=pair_hi,
            wall_face_counts=counts3,
            margin=_margin_from_bbox(
                moments["count"], moments["cmin"], moments["cmax"], stack.shape
            ),
        )
    raise RuntimeError("sharded blocked sweep failed to converge on buffer sizes")


def analyze_sharded_chunked(
    stack: LabeledStack,
    mesh: Optional[Mesh] = None,
    max_pairs: Optional[int] = None,
    chunk: Optional[int] = None,
) -> FeatureTable:
    """Chunked-engine z-slab sharding (2D images and fallback)."""
    if mesh is None:
        mesh = make_mesh()
    n = stack.n_labels
    # chunk bound and hi/lo split shift are functions of the PADDED shape —
    # the sharded kernel derives coordinates from padded flat offsets
    n_dev = mesh.shape["z"]
    zp = -(-stack.shape[0] // n_dev) * n_dev
    padded_shape = (zp,) + stack.shape[1:]
    if chunk is None:
        chunk = segred.pick_chunk(padded_shape)
    if max_pairs is None:
        max_pairs = stencil.default_max_pairs(n)

    dense = stack.dense.astype(jnp.int32)
    z = stack.shape[0]
    if zp != z:
        dense = jnp.pad(
            dense,
            ((0, zp - z),) + ((0, 0),) * (stack.ndim - 1),
            constant_values=n,
        )
    dense = jax.device_put(
        dense,
        NamedSharding(mesh, P("z", *(None,) * (stack.ndim - 1))),
    )
    tables, cmin, cmax, pair_lo, pair_hi, counts, n_pairs, margin = (
        sharded_pipeline(dense, n, chunk, max_pairs, mesh, z)
    )
    moments = segred.combine_moment_partials(
        np.asarray(tables), np.asarray(cmin), np.asarray(cmax), padded_shape
    )
    n_pairs = int(n_pairs)
    if n_pairs > max_pairs:
        return analyze_sharded_chunked(
            stack, mesh=mesh, max_pairs=n_pairs, chunk=chunk
        )

    return FeatureTable(
        ids=stack.ids.copy(),
        shape=stack.shape,
        voxelsize=stack.voxelsize,
        background_segment=stack.background_segment,
        count=moments["count"],
        s1=moments["s1"],
        s2=moments["s2"],
        cmin=moments["cmin"],
        cmax=moments["cmax"],
        pair_lo=np.asarray(pair_lo)[:n_pairs].astype(np.int32),
        pair_hi=np.asarray(pair_hi)[:n_pairs].astype(np.int32),
        wall_face_counts=np.asarray(counts)[:n_pairs].astype(np.int64),
        margin=np.asarray(margin),
    )
