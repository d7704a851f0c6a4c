"""Fused segment-moment sweep.

ONE pass over the labeled stack yields, per label: voxel count, Σcoord,
packed Σcoordᵢ·coordⱼ, and per-axis coordinate min/max — i.e. everything the
reference computes with separate `nd.sum` / `nd.center_of_mass` /
`nd.find_objects` / per-label variance passes
(``spatial_image_analysis.py :: volume / center_of_mass / boundingbox /
inertia_axis``), in a single sweep (SURVEY.md §7.2).

Exactness design:
- all accumulation is int32 with per-chunk bounds chosen so nothing can
  overflow; second moments are split into hi/lo parts (shift ``s``) so every
  summand is < 2**s;
- chunk partial tables are combined into exact int64 on the host, so the
  device never accumulates in int64;
- per-chunk work is a rectangular `segment_sum` / `segment_min` / `segment_max`
  (one scatter per chunk, F columns wide), driven by `lax.map` so device
  memory stays at one chunk of features.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tissue_analysis_tpu.features.finalize import tri_pairs

__all__ = [
    "moment_sweep",
    "moment_chunks",
    "pad_flat",
    "combine_moment_partials",
    "feature_count",
    "pick_chunk",
]

_INT32_MAX = 2**31 - 1


def feature_count(ndim: int) -> int:
    """1 (count) + D (Σcoord) + 2·P (hi/lo packed second moments)."""
    p = ndim * (ndim + 1) // 2
    return 1 + ndim + 2 * p


def _split_shift(shape: Tuple[int, ...]) -> int:
    """Smallest s with 2**s > max coordinate (so hi and lo parts are < 2**s)."""
    max_c = max(int(s) - 1 for s in shape)
    return max(1, max_c.bit_length())


def pick_chunk(shape: Tuple[int, ...]) -> int:
    """Largest safe chunk size: chunk · (2**s − 1) must fit int32."""
    s = _split_shift(shape)
    v = math.prod(int(d) for d in shape)
    k = min(_INT32_MAX // (2**s), 1 << 21, v)
    return max(k, 1)


def _chunk_features(seg: jax.Array, start, shape, shift: int):
    """Per-voxel int32 feature rows [K, F] + coords [K, D] for one flat chunk."""
    k = seg.shape[0]
    ndim = len(shape)
    gidx = start + jnp.arange(k, dtype=jnp.int32)
    coords = []
    rem = gidx
    for d in range(ndim):
        stride = int(math.prod(shape[d + 1 :]))
        c = rem // stride
        rem = rem - c * stride
        coords.append(c.astype(jnp.int32))
    cols = [jnp.ones((k,), jnp.int32)] + list(coords)
    mask = (1 << shift) - 1
    for (i, j) in tri_pairs(ndim):
        prod = coords[i] * coords[j]
        cols.append(prod >> shift)  # hi
        cols.append(prod & mask)  # lo
    feats = jnp.stack(cols, axis=1)
    coords = jnp.stack(coords, axis=1)
    return feats, coords


def moment_chunks(
    flat: jax.Array,
    flat_start,
    shape: Tuple[int, ...],
    n_labels: int,
    chunk: int,
):
    """Chunked moment partials over a flat (already padded) label slice.

    ``flat`` must have length divisible by ``chunk``, padded with the value
    ``n_labels`` (the dropped pad segment); ``flat_start`` is the global flat
    index of ``flat[0]`` within the full stack of shape ``shape`` (this is
    what lets z-slab shards reuse the same kernel — slabs are contiguous in
    flat order, SURVEY.md §7.5).
    """
    shift = _split_shift(shape)
    n_chunks = flat.shape[0] // chunk
    flat_start = jnp.asarray(flat_start, jnp.int32)

    def body(c):
        start = c * chunk
        seg = jax.lax.dynamic_slice(flat, (start,), (chunk,))
        feats, coords = _chunk_features(seg, flat_start + start, shape, shift)
        table = jax.ops.segment_sum(feats, seg, num_segments=n_labels + 1)
        cmin = jax.ops.segment_min(coords, seg, num_segments=n_labels + 1)
        cmax = jax.ops.segment_max(coords, seg, num_segments=n_labels + 1)
        return table[:n_labels], cmin[:n_labels], cmax[:n_labels]

    return jax.lax.map(body, jnp.arange(n_chunks, dtype=jnp.int32))


def pad_flat(dense: jax.Array, n_labels: int, chunk: int) -> jax.Array:
    """Flatten and pad with the dropped pad-segment value ``n_labels``."""
    v = math.prod(dense.shape)
    n_chunks = -(-v // chunk)
    pad = n_chunks * chunk - v
    return jnp.concatenate(
        [dense.reshape(-1), jnp.full((pad,), n_labels, dense.dtype)]
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_labels", "chunk"))
def moment_sweep(dense: jax.Array, n_labels: int, chunk: int):
    """Chunked moment partials for a whole (single-device) stack.

    Returns (per-chunk, the extra pad segment already stripped):
      tables : int32 [C, N, F]   summed feature rows
      cmin   : int32 [C, N, D]   per-axis min (int32 max where empty)
      cmax   : int32 [C, N, D]   per-axis max (int32 min where empty)
    """
    shape = tuple(dense.shape)
    if math.prod(shape) > _INT32_MAX:
        raise ValueError("stack too large for int32 flat indexing")
    flat = pad_flat(dense, n_labels, chunk)
    return moment_chunks(flat, 0, shape, n_labels, chunk)


def combine_moment_partials(
    tables: np.ndarray,
    cmin: np.ndarray,
    cmax: np.ndarray,
    shape: Tuple[int, ...],
) -> Dict[str, np.ndarray]:
    """Host-side exact int64 combine of per-chunk partials.

    Output dict: count int64[N], s1 int64[N,D], s2 int64[N,P], cmin/cmax
    int64[N,D] (0 where the label is absent).
    """
    ndim = len(shape)
    shift = _split_shift(shape)
    tab = np.asarray(tables, dtype=np.int64).sum(axis=0)
    count = tab[:, 0]
    s1 = tab[:, 1 : 1 + ndim]
    p = ndim * (ndim + 1) // 2
    hi = tab[:, 1 + ndim : 1 + ndim + 2 * p : 2]
    lo = tab[:, 2 + ndim : 2 + ndim + 2 * p : 2]
    s2 = (hi << shift) + lo
    mn = np.asarray(cmin, dtype=np.int64).min(axis=0)
    mx = np.asarray(cmax, dtype=np.int64).max(axis=0)
    empty = count == 0
    mn[empty] = 0
    mx[empty] = 0
    return {"count": count, "s1": s1, "s2": s2, "cmin": mn, "cmax": mx}
