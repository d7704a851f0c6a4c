"""Golden oracle: the reference's semantics in direct scipy.ndimage calls.

The reference repo (``VirtualPlants/tissue_analysis``) bottoms out in
documented scipy.ndimage / numpy primitives (SURVEY.md §2.2); its mount was
empty this session, so this oracle — written from SURVEY.md §3's behavioral
traces, NOT ported code — is the executable parity target for the device
engines:

- volume        → ``nd.sum(ones, img, index)``           (§3.2)
- barycenter    → ``nd.center_of_mass``                   (§3.2)
- boundingbox   → ``nd.find_objects`` (1-indexed, None-for-absent) (§3.2)
- neighbors     → per-label ``nd.binary_dilation`` with the default cross
                  structuring element = 6-connectivity in 3D (§3.3)
- wall faces    → per-axis shifted comparisons, each adjacent voxel pair
                  counted once; anisotropic face areas ∏v/v_d (§3.4)
- inertia_axis  → exact integer coordinate moments routed through the SAME
                  canonical finalizer as the engine (features.finalize), so
                  float results are bit-comparable (§7 exactness rule)

The per-label paths are deliberately slow (they ARE the baseline cost
model). :meth:`ScipyOracle.integer_moments_vectorized`,
:meth:`ScipyOracle.wall_face_table` and :meth:`ScipyOracle.feature_table`
compute the same exact integers in a few whole-array numpy passes, so a
512³ stack can be checked in seconds.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as nd

from tissue_analysis_tpu.features import finalize

__all__ = ["ScipyOracle"]

# voxels per pass of the vectorised moments (bounds the int64 temporaries)
_VOXELS_PER_PASS = 1 << 21


def _dilate_slices(slices, shape, amount=1):
    """Grow a slice tuple by ``amount``, clamped to the array (``:: dilation``)."""
    return tuple(
        slice(max(0, s.start - amount), min(dim, s.stop + amount))
        for s, dim in zip(slices, shape)
    )


class ScipyOracle:
    def __init__(self, image, voxelsize=None, background: Optional[int] = 1):
        self.image = np.asarray(image)
        if voxelsize is None:
            voxelsize = getattr(image, "voxelsize", (1.0,) * self.image.ndim)
        self.voxelsize = tuple(float(v) for v in voxelsize)
        self.background = background
        img = self.image
        if img.dtype.itemsize <= 2 and img.dtype.kind == "u":
            # O(V) presence count instead of an O(V log V) sort
            self.labels = np.flatnonzero(np.bincount(img.ravel()))
        else:
            self.labels = np.unique(img)
        self.labels = self.labels.astype(np.int64)

    # ------------------------------------------------------------- features
    def volume(self, real: bool = True) -> Dict[int, float]:
        ones = np.ones_like(self.image, dtype=np.float64)
        vals = nd.sum(ones, self.image, index=self.labels)
        if real:
            vals = vals * float(np.prod(np.asarray(self.voxelsize, np.float64)))
        return {int(l): v for l, v in zip(self.labels, np.atleast_1d(vals))}

    def barycenter(self, real: bool = True) -> Dict[int, np.ndarray]:
        ones = np.ones_like(self.image, dtype=np.float64)
        coms = nd.center_of_mass(ones, self.image, index=self.labels)
        out = {}
        for l, c in zip(self.labels, coms):
            c = np.asarray(c, dtype=np.float64)
            if real:
                c = c * np.asarray(self.voxelsize, np.float64)
            out[int(l)] = c
        return out

    def boundingbox(self) -> Dict[int, Optional[Tuple[slice, ...]]]:
        img = self.image.astype(np.int64)
        objs = nd.find_objects(img)  # slot i ↔ label i+1
        out: Dict[int, Optional[Tuple[slice, ...]]] = {}
        for l in self.labels:
            li = int(l)
            out[li] = objs[li - 1] if 1 <= li <= len(objs) else None
        return out

    # ------------------------------------------------------------ adjacency
    def neighbors(
        self,
        labels: Optional[Sequence[int]] = None,
        connectivity: int = 1,
        min_contact_area: Optional[float] = None,
        real: bool = True,
    ) -> Dict[int, List[int]]:
        """Per-label dilation adjacency (SURVEY.md §3.3)."""
        img = self.image
        struct = nd.generate_binary_structure(img.ndim, connectivity)
        bboxes = self.boundingbox()
        areas = self.wall_pairs(real=real) if min_contact_area is not None else None
        out: Dict[int, List[int]] = {}
        for l in self.labels if labels is None else labels:
            li = int(l)
            bb = bboxes.get(li)
            if bb is None:
                out[li] = []
                continue
            sl = _dilate_slices(bb, img.shape)
            sub = img[sl]
            mask = sub == li
            dil = nd.binary_dilation(mask, structure=struct)
            neigh = np.unique(sub[dil & ~mask])
            nl = [int(x) for x in neigh]
            if min_contact_area is not None:
                nl = [
                    x
                    for x in nl
                    if areas.get((min(li, x), max(li, x)), 0.0) >= min_contact_area
                ]
            out[li] = sorted(nl)
        return out

    def wall_pairs(self, real: bool = True) -> Dict[Tuple[int, int], float]:
        """{(a, b) a<b: wall measure} — real area or total face count.

        Each 6-adjacent voxel pair with differing labels contributes one
        face; per-axis face area = ∏voxelsize / voxelsize_d (§3.4).
        """
        v = np.asarray(self.voxelsize, np.float64)
        face_area = np.prod(v) / v
        out: Dict[Tuple[int, int], float] = {}
        for a, b, counts in zip(*self.wall_face_table()):
            total = 0.0
            for d, c in enumerate(counts):
                if c:
                    total += c * (float(face_area[d]) if real else 1.0)
            out[(int(a), int(b))] = total
        return out

    def cell_wall_surface(self, l1: int, l2: int, real: bool = True) -> float:
        pair = (min(l1, l2), max(l1, l2))
        return self.wall_pairs(real=real).get(pair, 0.0)

    # ----------------------------------------------- epidermis/L1/margins
    def cells_in_image_margins(self) -> List[int]:
        img = self.image
        vals = []
        for d in range(img.ndim):
            vals.append(np.take(img, 0, axis=d).ravel())
            vals.append(np.take(img, img.shape[d] - 1, axis=d).ravel())
        return sorted(int(x) for x in np.unique(np.concatenate(vals)))

    def l1(self) -> List[int]:
        """Cells adjacent to background (``:: L1``)."""
        if self.background is None:
            return []
        nbh = self.neighbors()
        return sorted(
            int(l)
            for l in self.labels
            if int(l) != self.background and self.background in nbh[int(l)]
        )

    def epidermis_surface(self, real: bool = True) -> Dict[int, float]:
        """Wall area with the background per L1 cell (``:: epidermis_surface``)."""
        if self.background is None:
            return {}
        pairs = self.wall_pairs(real=real)
        out: Dict[int, float] = {}
        for (a, b), area in pairs.items():
            if a == self.background and b != self.background:
                out[b] = out.get(b, 0.0) + area
            elif b == self.background and a != self.background:
                out[a] = out.get(a, 0.0) + area
        return out

    # ------------------------------------------------------------- moments
    def integer_moments(self):
        """Exact int64 moments per label — engine-comparable ground truth."""
        img = self.image
        labels = self.labels
        d = img.ndim
        pairs = finalize.tri_pairs(d)
        n = labels.shape[0]
        count = np.zeros(n, np.int64)
        s1 = np.zeros((n, d), np.int64)
        s2 = np.zeros((n, len(pairs)), np.int64)
        cmin = np.zeros((n, d), np.int64)
        cmax = np.zeros((n, d), np.int64)
        for k, l in enumerate(labels):
            coords = np.nonzero(img == l)
            count[k] = coords[0].shape[0]
            if count[k] == 0:
                continue
            cs = [c.astype(np.int64) for c in coords]
            for a in range(d):
                s1[k, a] = cs[a].sum()
                cmin[k, a] = cs[a].min()
                cmax[k, a] = cs[a].max()
            for col, (i, j) in enumerate(pairs):
                s2[k, col] = np.sum(cs[i] * cs[j])
        return count, s1, s2, cmin, cmax

    def _label_index(self, chunk: np.ndarray) -> np.ndarray:
        """Position of each voxel's label in ``self.labels`` (int64)."""
        labels = self.labels
        if labels[0] >= 0 and labels[-1] < (1 << 24):
            lut = np.zeros(int(labels[-1]) + 1, np.int64)
            lut[labels] = np.arange(labels.shape[0])
            return lut[chunk]
        return np.searchsorted(labels, chunk)

    def integer_moments_vectorized(self, workers: int = 1):
        """:meth:`integer_moments`, computed in whole-array passes.

        Counts and coordinate sums are ``np.bincount``s over the label
        index, one pass per block of whole planes (``_VOXELS_PER_PASS``
        voxels), accumulated in int64. The float64 weights and sums of a
        pass are exact integers while voxels_per_pass·(max extent − 1)² <
        2⁵³ (checked; a 1024³ stack uses under 0.1% of that). cmin/cmax
        come from a stable sort of the label index and
        ``minimum/maximum.reduceat`` over each label's run. ``workers``
        threads run the passes (numpy releases the GIL inside them).
        """
        img = self.image
        d = img.ndim
        n = self.labels.shape[0]
        pairs = finalize.tri_pairs(d)
        plane = int(np.prod(img.shape[1:]))
        step = max(1, _VOXELS_PER_PASS // plane)
        if step * plane * (max(img.shape) - 1) ** 2 >= 2**53:
            raise ValueError("stack too wide for exact float64 bincounts")
        # a 16-bit sort key takes numpy's O(V) radix sort
        sort_dtype = np.uint16 if n <= 1 << 16 else np.int64

        def one_pass(z0):
            chunk = img[z0:z0 + step]
            idx = self._label_index(chunk).ravel()
            grids = np.indices(chunk.shape, dtype=np.int64)
            grids[0] += z0
            cs = [g.ravel() for g in grids]

            def bsum(w=None):
                return np.bincount(idx, weights=w, minlength=n).astype(np.int64)

            count = bsum()
            s1 = np.stack([bsum(c.astype(np.float64)) for c in cs], axis=1)
            s2 = np.stack(
                [bsum((cs[i] * cs[j]).astype(np.float64)) for i, j in pairs],
                axis=1,
            )
            order = np.argsort(idx.astype(sort_dtype), kind="stable")
            sidx = idx[order]
            starts = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
            cmin = np.stack(
                [np.minimum.reduceat(c[order], starts) for c in cs], axis=1
            )
            cmax = np.stack(
                [np.maximum.reduceat(c[order], starts) for c in cs], axis=1
            )
            return count, s1, s2, sidx[starts], cmin, cmax

        count = np.zeros(n, np.int64)
        s1 = np.zeros((n, d), np.int64)
        s2 = np.zeros((n, len(pairs)), np.int64)
        cmin = np.full((n, d), np.iinfo(np.int64).max)
        cmax = np.full((n, d), np.iinfo(np.int64).min)
        with ThreadPoolExecutor(max(1, workers)) as pool:
            for c, a, b, present, lo, hi in pool.map(
                one_pass, range(0, img.shape[0], step)
            ):
                count += c
                s1 += a
                s2 += b
                cmin[present] = np.minimum(cmin[present], lo)
                cmax[present] = np.maximum(cmax[present], hi)
        absent = count == 0
        cmin[absent] = 0
        cmax[absent] = 0
        return count, s1, s2, cmin, cmax

    def wall_face_table(self):
        """Per-axis face counts of every wall, vectorised.

        Returns (lo, hi, counts) with label ids lo < hi (int64, sorted
        ascending by (lo, hi)) and counts int64[P, ndim] — axis d counts
        the 6-adjacent voxel pairs along d, each pair once (§3.4).
        """
        img = self.image
        d = img.ndim
        keys, axes = [], []
        base = int(self.labels.max()) + 1
        for ax in range(d):
            sl_a = [slice(None)] * d
            sl_b = [slice(None)] * d
            sl_a[ax] = slice(0, -1)
            sl_b[ax] = slice(1, None)
            a = img[tuple(sl_a)].ravel()
            b = img[tuple(sl_b)].ravel()
            diff = a != b
            a, b = a[diff].astype(np.int64), b[diff].astype(np.int64)
            keys.append(np.minimum(a, b) * base + np.maximum(a, b))
            axes.append(np.full(keys[-1].shape, ax, np.int64))
        key = np.concatenate(keys)
        ax = np.concatenate(axes)
        uk, inv = np.unique(key, return_inverse=True)
        counts = np.zeros((uk.shape[0], d), np.int64)
        np.add.at(counts, (inv.ravel(), ax), 1)
        return uk // base, uk % base, counts

    def feature_table(self, workers: int = 1):
        """The whole FeatureTable the engines must reproduce, bit for bit.

        Exact integers from :meth:`integer_moments_vectorized`,
        :meth:`wall_face_table` and :meth:`cells_in_image_margins`, laid out
        in the engines' convention: ids ascending with the background
        swapped to segment 0, pairs as (lo < hi) segment ids sorted
        ascending.
        """
        from tissue_analysis_tpu.features.table import FeatureTable

        count, s1, s2, cmin, cmax = self.integer_moments_vectorized(workers)
        ids = self.labels.copy()
        perm = np.arange(ids.shape[0])
        bseg = None
        if self.background is not None:
            pos = int(np.searchsorted(ids, self.background))
            if pos < ids.shape[0] and ids[pos] == self.background:
                perm[[0, pos]] = perm[[pos, 0]]
                bseg = 0
        ids = ids[perm]
        lo, hi, counts = self.wall_face_table()
        seg_lo = np.searchsorted(self.labels, lo)
        seg_hi = np.searchsorted(self.labels, hi)
        seg_of_rank = np.argsort(perm)  # label rank -> segment
        a, b = seg_of_rank[seg_lo], seg_of_rank[seg_hi]
        plo, phi = np.minimum(a, b), np.maximum(a, b)
        order = np.argsort((plo << 32) | phi)
        margin_ids = np.asarray(self.cells_in_image_margins(), np.int64)
        return FeatureTable(
            ids=ids,
            shape=tuple(int(v) for v in self.image.shape),
            voxelsize=self.voxelsize,
            background_segment=bseg,
            count=count[perm],
            s1=s1[perm],
            s2=s2[perm],
            cmin=cmin[perm],
            cmax=cmax[perm],
            pair_lo=plo[order].astype(np.int32),
            pair_hi=phi[order].astype(np.int32),
            wall_face_counts=counts[order],
            margin=np.isin(ids, margin_ids),
        )

    def inertia_axes(self, real: bool = True):
        count, s1, s2, _, _ = self.integer_moments()
        evals, evecs = finalize.inertia_axes(
            count, s1, s2, self.voxelsize if real else None
        )
        return (
            {int(l): evals[k] for k, l in enumerate(self.labels)},
            {int(l): evecs[k] for k, l in enumerate(self.labels)},
        )
