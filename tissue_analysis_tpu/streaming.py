"""Out-of-core streamed analysis — stacks larger than device HBM.

The reference is bounded only by host RAM (``spatial_image_analysis.py``
holds one numpy array and runs scipy passes over it; SURVEY.md §3.5). The
resident device engines here are instead bounded by device memory. This
module removes that bound: the stack is processed as a sequence of z-slabs
through the SAME slab primitives the z-shard pipeline uses
(``ops.blocked._build_slab_fns``), with the slab↔slab z-seam handled exactly
like the sharded ring halo (previous slab's last plane vs current first
plane, lower-z owner) and all partials combined on host in exact int64 —
so the resulting FeatureTable is BIT-IDENTICAL to the resident engines at
any depth, while HBM holds one slab at a time.

Two tricks make arbitrary stack sizes exact:

- every slab runs with ``z_off=0`` (slab-local z), keeping the engines'
  int32 reconstruction bounds a function of the SLAB shape only; the global
  z offset is re-applied on host in int64 (``_shift_moments_z``), which is
  exact because the moments are exact integers;
- label discovery is a separate streaming presence scan (bincount for
  ≤16-bit dtypes, per-slab ``np.unique`` otherwise), so the dense relabel
  LUT exists before the first voxel reaches the device and no full-image
  host pass is ever required either.

Sources are anything exposing ``shape``/``dtype``/``read(z0, z1)`` —
in-memory arrays, ``np.memmap``, or purely synthetic generators
(:class:`TiledSource` materializes nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tissue_analysis_tpu.features.table import FeatureTable
from tissue_analysis_tpu.ops import blocked

__all__ = [
    "ArraySource",
    "TiledSource",
    "analyze_streamed",
]


# ---------------------------------------------------------------------------
# Slab sources
# ---------------------------------------------------------------------------


class ArraySource:
    """Slab source over a host array (ndarray or np.memmap)."""

    def __init__(self, array, voxelsize: Optional[Tuple[float, ...]] = None):
        self.array = array
        self.shape = tuple(int(s) for s in array.shape)
        self.dtype = array.dtype
        self.voxelsize = voxelsize or getattr(array, "voxelsize", None)

    def read(self, z0: int, z1: int) -> np.ndarray:
        return np.asarray(self.array[z0:z1])


class TiledSource:
    """Synthetic (tz, ty, tx) tiling of a base stack with per-tile label
    offsets — generates any slab on demand, materializing nothing.

    Labels other than the background get ``tile_index * stride`` added, so
    every tile holds distinct cells whose per-cell features must bit-match
    the base stack's (the scale-up validation recipe from BASELINE.md).
    """

    def __init__(self, base: np.ndarray, tiles: Tuple[int, int, int],
                 background: int = 1, stride: Optional[int] = None):
        self.base = np.asarray(base)
        self.tiles = tiles
        self.background = background
        self.stride = int(stride or (int(self.base.max()) + 1))
        self.shape = tuple(
            int(t * s) for t, s in zip(tiles, self.base.shape)
        )
        need = self.stride * (tiles[0] * tiles[1] * tiles[2] + 1)
        self.dtype = np.uint16 if need <= 0xFFFF else np.int32
        self.voxelsize = None

    def read(self, z0: int, z1: int) -> np.ndarray:
        bz, by, bx = self.base.shape
        _, ty, tx = self.tiles
        out = np.empty((z1 - z0, by * ty, bx * tx), dtype=self.dtype)
        for z in range(z0, z1):
            tz, lz = divmod(z, bz)
            plane = self.base[lz].astype(np.int64)
            row = np.concatenate(
                [
                    np.where(
                        plane == self.background,
                        plane,
                        plane + ((tz * ty + iy) * tx + ix) * self.stride,
                    )
                    for iy in range(ty)
                    for ix in range(tx)
                ],
                axis=None,
            ).reshape(ty, tx, by, bx).transpose(0, 2, 1, 3).reshape(
                by * ty, bx * tx
            )
            out[z - z0] = row
        return out


# ---------------------------------------------------------------------------
# Streaming label discovery + relabel LUT
# ---------------------------------------------------------------------------


def _scan_ids(source, slab_z: int, background) -> Tuple[np.ndarray, Optional[int]]:
    """Streaming presence scan → (ids int64[n] in LabeledStack order
    (sorted ascending, background swapped to segment 0), background_segment).
    """
    z = source.shape[0]
    small = np.dtype(source.dtype).itemsize <= 2
    if small:
        present = np.zeros(1 << 16, dtype=bool)
        for z0 in range(0, z, slab_z):
            slab = source.read(z0, min(z0 + slab_z, z))
            counts = np.bincount(slab.reshape(-1), minlength=1 << 16)
            present |= counts > 0
        ids = np.nonzero(present)[0].astype(np.int64)
    else:
        ids = np.zeros(0, dtype=np.int64)
        for z0 in range(0, z, slab_z):
            slab = source.read(z0, min(z0 + slab_z, z))
            ids = np.union1d(ids, np.unique(slab).astype(np.int64))
    background_segment = None
    if background is not None:
        pos = int(np.searchsorted(ids, background))
        if pos < ids.shape[0] and ids[pos] == background:
            if pos != 0:
                ids = ids.copy()
                ids[0], ids[pos] = ids[pos], ids[0]
            background_segment = 0
    return ids, background_segment


def _make_relabel(ids: np.ndarray, dtype) -> "callable":
    """Vectorized original-label → dense-segment mapper honoring the
    background swap encoded in ``ids`` (segment i = ids[i])."""
    n = ids.shape[0]
    out_dtype = np.uint16 if n <= 0xFFFF else np.int32
    if np.dtype(dtype).itemsize <= 2:
        lut = np.zeros(1 << 16, dtype=out_dtype)
        lut[ids] = np.arange(n, dtype=out_dtype)
        return lambda slab: lut[slab]
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    seg_of_rank = order.astype(out_dtype)

    def relabel(slab):
        return seg_of_rank[np.searchsorted(ids_sorted, slab)]

    return relabel


# ---------------------------------------------------------------------------
# Per-slab device programs (built once per static config, reused per slab)
# ---------------------------------------------------------------------------


def _pack_readback(mom, k1, k2, total, n_runs, dovf, povf):
    """Stack the per-slab outputs into 3 readback buffers: moment block,
    pair table, stats vector = [n_runs, dovf, povf, k2_marker]."""
    if k2.shape[0] == 1:  # packed-key mode: k2 is the [1] 4n marker
        pairs = jnp.stack([k1, total])
    else:  # two-key mode (4n^2 >= 2^31)
        pairs = jnp.stack([k1, k2, total])
    stats = jnp.stack(
        [n_runs, dovf.astype(jnp.int32), povf.astype(jnp.int32), k2[0]]
    )
    return mom, pairs, stats


def _unpack_readback(mom, pairs, stats):
    """Host inverse of :func:`_pack_readback`."""
    n_runs, dovf, povf, k2_marker = (int(v) for v in stats)
    if pairs.shape[0] == 2:
        k1, total = pairs
        k2 = np.array([k2_marker], np.int32)
    else:
        k1, k2, total = pairs
    return mom, k1, k2, total, n_runs, bool(dovf), bool(povf)


def _build_program_blocked(slab_shape, n, cfg, wshift, max_entries):
    main, cross_seam = blocked._build_slab_fns(slab_shape, n, cfg, wshift)
    by, bx = cfg.block[1], cfg.block[2]
    y, x = slab_shape[1], slab_shape[2]
    yp, xp = -(-y // by) * by, -(-x // bx) * bx

    def program(dense_slab, prev_last):
        ids, cols, cmin, cmax, los, his, counts, tags, dovf, povf = main(
            dense_slab, 0
        )
        first = jnp.pad(
            dense_slab[0].astype(jnp.int32),
            ((0, yp - y), (0, xp - x)), constant_values=n,
        )
        lo_s, hi_s, ct_s, dovf_s, povf_s = cross_seam(prev_last, first)
        los = jnp.concatenate([los, lo_s])
        his = jnp.concatenate([his, hi_s])
        counts = jnp.concatenate([counts, ct_s])
        tags = jnp.concatenate([tags, jnp.zeros(lo_s.shape, jnp.int32)])
        table, gmin, gmax = blocked._global_moment_combine(
            ids, cols, cmin, cmax, n
        )
        k1, k2, total, n_runs = blocked._sorted_pair_reduce(
            los, his, tags, counts, max_entries, n_labels=n, unpack=False
        )
        last = jnp.pad(
            dense_slab[-1].astype(jnp.int32),
            ((0, yp - y), (0, xp - x)), constant_values=n,
        )
        # device-side base-2^32 packing: [n, 26] per-slab moment readback
        # instead of [n, 46]
        mom = blocked.pack_moments_blocked(table, gmin, gmax, wshift)
        return _pack_readback(
            mom, k1, k2, total, n_runs, dovf | dovf_s, povf | povf_s
        ) + (last,)

    return jax.jit(program)


# ---------------------------------------------------------------------------
# Host-side exact combine
# ---------------------------------------------------------------------------


def _shift_moments_z(m: dict, z0: int) -> dict:
    """Re-apply the global z offset to slab-local moments, exactly (int64).

    s2 column order is zz, zy, zx, yy, yx, xx (features.finalize.tri_pairs);
    s2 updates use the LOCAL s1, so they run first.
    """
    z0 = np.int64(z0)
    count, s1, s2 = m["count"], m["s1"], m["s2"]
    s2[:, 0] += 2 * z0 * s1[:, 0] + z0 * z0 * count
    s2[:, 1] += z0 * s1[:, 1]
    s2[:, 2] += z0 * s1[:, 2]
    s1[:, 0] += z0 * count
    present = count > 0
    m["cmin"][present, 0] += z0
    m["cmax"][present, 0] += z0
    return m


class _Accumulator:
    """Exact int64 running combine of per-slab moment/pair partials."""

    def __init__(self, n: int):
        self.count = np.zeros(n, np.int64)
        self.s1 = np.zeros((n, 3), np.int64)
        self.s2 = np.zeros((n, 6), np.int64)
        self.cmin = np.full((n, 3), np.iinfo(np.int64).max)
        self.cmax = np.full((n, 3), np.iinfo(np.int64).min)
        self.pair_parts = []

    def add_moments(self, m: dict) -> None:
        self.count += m["count"]
        self.s1 += m["s1"]
        self.s2 += m["s2"]
        present = m["count"] > 0
        self.cmin[present] = np.minimum(self.cmin[present], m["cmin"][present])
        self.cmax[present] = np.maximum(self.cmax[present], m["cmax"][present])

    def add_pairs(self, lo, hi, counts3) -> None:
        self.pair_parts.append((lo, hi, counts3))

    def finish(self, ids, shape, voxelsize, background_segment) -> FeatureTable:
        from tissue_analysis_tpu.engine import _margin_from_bbox

        absent = self.count == 0
        self.cmin[absent] = 0
        self.cmax[absent] = 0
        if self.pair_parts:
            lo = np.concatenate([p[0] for p in self.pair_parts])
            hi = np.concatenate([p[1] for p in self.pair_parts])
            c3 = np.concatenate([p[2] for p in self.pair_parts])
            gk = (lo.astype(np.int64) << 32) | hi.astype(np.int64)
            uniq, inv = np.unique(gk, return_inverse=True)
            counts3 = np.zeros((uniq.shape[0], 3), dtype=np.int64)
            np.add.at(counts3, inv, c3)
            pair_lo = (uniq >> 32).astype(np.int32)
            pair_hi = (uniq & 0xFFFFFFFF).astype(np.int32)
        else:
            pair_lo = np.zeros(0, np.int32)
            pair_hi = np.zeros(0, np.int32)
            counts3 = np.zeros((0, 3), np.int64)
        return FeatureTable(
            ids=ids.copy(),
            shape=shape,
            voxelsize=voxelsize,
            background_segment=background_segment,
            count=self.count,
            s1=self.s1,
            s2=self.s2,
            cmin=self.cmin,
            cmax=self.cmax,
            pair_lo=pair_lo,
            pair_hi=pair_hi,
            wall_face_counts=counts3,
            margin=_margin_from_bbox(self.count, self.cmin, self.cmax, shape),
        )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def analyze_streamed(
    source,
    background: Optional[int] = 1,
    voxelsize: Optional[Tuple[float, ...]] = None,
    slab_z: Optional[int] = None,
    engine: str = "auto",
    cfg=None,
) -> FeatureTable:
    """Streamed out-of-core analysis → FeatureTable (bit-identical to
    :func:`engine.analyze_stack` on the same voxels).

    ``source``: a 3D host ndarray / np.memmap, or any object with
    ``shape``/``dtype``/``read(z0, z1)``. Device memory holds one
    (slab_z, Y, X) slab (plus bounded intermediates) regardless of stack
    depth. ``engine``: 'auto' or 'blocked' (the blocked slab program is
    the only streamed engine); ``cfg``: an optional
    :class:`~tissue_analysis_tpu.ops.blocked.BlockConfig`.
    """
    from tissue_analysis_tpu.utils import timing

    if engine not in ("auto", "blocked"):
        raise ValueError(
            f"analyze_streamed engine must be 'auto' or 'blocked', got "
            f"{engine!r}"
        )

    if isinstance(source, np.ndarray) or (
        hasattr(source, "shape") and not hasattr(source, "read")
    ):
        source = ArraySource(source, voxelsize=voxelsize)
    shape = tuple(int(s) for s in source.shape)
    if len(shape) != 3:
        raise ValueError("analyze_streamed expects a 3D source")
    if voxelsize is None:
        voxelsize = getattr(source, "voxelsize", None) or (1.0,) * 3
    voxelsize = tuple(float(v) for v in voxelsize)

    z, y, x = shape
    if slab_z is None:
        slab_z = min(128, -(-z // 8) * 8)

    with timing.stage("stream: presence scan", int(np.prod(shape))):
        ids, background_segment = _scan_ids(source, slab_z, background)
    n = int(ids.shape[0])
    relabel = _make_relabel(ids, source.dtype)

    cfg = cfg or blocked.BlockConfig()
    bz = cfg.block[0]
    if slab_z % bz:
        slab_z = -(-slab_z // bz) * bz
    slab_shape = (slab_z, y, x)

    programs: dict = {}

    def get_program(c):
        if c not in programs:
            max_entries = 3 * c.derived_max_pairs(n)
            wshift = blocked._check_static(slab_shape, n, c)
            programs[c] = _build_program_blocked(
                slab_shape, n, c, wshift, max_entries
            )
        return programs[c]

    acc = _Accumulator(n)
    # y/x-padded previous-last-plane buffer (the seam pass expects padding)
    by, bx = cfg.block[1], cfg.block[2]
    yp, xp = -(-y // by) * by, -(-x // bx) * bx
    prev_last = jnp.full((yp, xp), n, dtype=jnp.int32)

    def collect(pend):
        """Sync one dispatched slab; resolve overflow retries inline.

        Retries re-run the SAME device inputs (slab + its seam plane) with
        grown buffers — the seam plane handed to the next slab is just the
        slab's last z-plane, valid regardless of overflow, so pipelined
        later slabs never need re-dispatching for an earlier retry. The
        overflow checks use the config the slab RAN with: the shared config
        may have changed (tightened or grown) since it was dispatched.
        """
        nonlocal cfg
        z0, out, slab_dev, seam_in, used = pend
        for _attempt in range(12):
            with timing.stage(f"stream: slab z{z0} collect"):
                # out[-1] is the last z-plane seam — consumed ON DEVICE by
                # the next slab's program, never read back
                host = jax.device_get(out[:-1])
            mom, k1, k2, total, n_runs, dovf, povf = _unpack_readback(*host)
            if (
                dovf
                or povf
                or int(n_runs) > 3 * used.derived_max_pairs(n)
            ):
                used = cfg = _grow_cfg(used, dovf, povf, int(n_runs))
                out = get_program(used)(slab_dev, seam_in)
                continue
            m = blocked.assemble_moments_packed_blocked(mom)
            acc.add_moments(_shift_moments_z(m, z0))
            lo, hi, c3 = blocked.assemble_pairs(k1, k2, total)
            acc.add_pairs(lo, hi, c3)
            return int(n_runs)
        raise RuntimeError("streamed slab failed to converge on buffers")

    # software-pipelined loop: while the device runs slab k, the host
    # reads/relabels slab k+1 and enqueues its transfer — end-to-end time
    # approaches max(host ingest, device compute) instead of their sum
    pending = None
    first_runs = None
    for z0 in range(0, z, slab_z):
        z1 = min(z0 + slab_z, z)
        with timing.stage(f"stream: slab z{z0} read+relabel"):
            slab = relabel(source.read(z0, z1))
            if z1 - z0 < slab_z:
                pad = np.full(
                    (slab_z - (z1 - z0), y, x), n, dtype=slab.dtype
                )
                slab = np.concatenate([slab, pad], axis=0)
        slab_dev = jnp.asarray(slab)  # async H2D
        seam_in = prev_last
        used = cfg
        out = get_program(used)(slab_dev, seam_in)  # async dispatch
        prev_last = out[-1]  # device future; exact even if buffers overflow
        if pending is not None:
            runs = collect(pending)
            if first_runs is None:
                first_runs = runs
                # tighten max_pairs to the measured per-slab run count (the
                # default 24·n sizes the PAIR READBACK arrays — at 50k+
                # labels that is ~48 MB of mostly-sentinel payload PER
                # SLAB). Slabs of a stack are statistically alike, so slab
                # 0's n_runs ×2 headroom holds; a later spike still
                # converges through the n_runs retry in `collect`.
                tight = max(2048, -(-runs * 2 // 3) + 64)
                if not cfg.max_pairs and 4 * tight < cfg.derived_max_pairs(n):
                    cfg = dataclasses.replace(cfg, max_pairs=tight)
        pending = (z0, out, slab_dev, seam_in, used)
    if pending is not None:
        collect(pending)

    return acc.finish(ids, shape, voxelsize, background_segment)


def _grow_cfg(cfg, dovf: bool, povf: bool, n_runs: int):
    if dovf:
        return dataclasses.replace(
            cfg, max_labels_per_block=cfg.max_labels_per_block * 4
        )
    if povf:
        return dataclasses.replace(
            cfg, max_pairs_per_block=cfg.max_pairs_per_block * 4
        )
    return dataclasses.replace(cfg, max_pairs=-(-n_runs // 3) + 16)
