"""Time-series batch analysis (BASELINE config 5).

The reference processes a confocal time series as a Python loop of
independent `graph_from_image` calls (SURVEY.md §3.5/§3.6). Here a series is
a first-class batch:

- `analyze_series`: per-timepoint FeatureTables with ONE compilation shared
  across frames — the blocked sweep is compiled for a bucketed label count
  (next power of two ≥ every frame's), so differing cell counts don't
  retrigger compilation. Frames stream through the single-device engine,
  optionally placed round-robin over several devices (``devices=``); they
  are still analyzed one after another.
- `graph_series`: the per-timepoint cell PropertyGraphs.
- `temporal_graph_from_images`: full pipeline — per-frame graphs +
  lineage mappings → one `TemporalPropertyGraph` (the reference's
  `TemporalPropertyGraph.extend` flow).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.engine import analyze_stack, analyze_stack_blocked
from tissue_analysis_tpu.features.table import FeatureTable
from tissue_analysis_tpu.graph.from_image import graph_from_table
from tissue_analysis_tpu.graph.property_graph import (
    PropertyGraph,
    TemporalPropertyGraph,
)

__all__ = [
    "analyze_series",
    "graph_series",
    "temporal_graph_from_images",
    "read_lineage",
    "write_lineage",
]


def read_lineage(path: str) -> Dict[int, List[int]]:
    """Read a lineage mapping file: ``mother: d1 d2 ...`` or ``mother d1 d2``
    per line (the MARS-ALT tracking output convention); '#' comments."""
    out: Dict[int, List[int]] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            head, _, rest = line.partition(":")
            parts = (head + " " + rest).split()
            ids = [int(p) for p in parts]
            if len(ids) < 2:
                continue
            out.setdefault(ids[0], []).extend(ids[1:])
    return out


def write_lineage(path: str, lineage: Dict[int, List[int]]) -> None:
    with open(path, "w") as f:
        for mother in sorted(lineage):
            ds = lineage[mother]
            if not isinstance(ds, (list, tuple, set)):
                ds = [ds]
            f.write(f"{int(mother)}: {' '.join(str(int(d)) for d in ds)}\n")


def _bucket(n: int) -> int:
    b = 64
    while b < n:
        b <<= 1
    return b


def analyze_series(
    images: Sequence,
    background: Optional[int] = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
) -> List[FeatureTable]:
    """Per-timepoint FeatureTables with shared compilation.

    All frames must share one shape for compile reuse (standard for a
    registered confocal series); mixed shapes fall back to per-shape
    compilation transparently. `devices`: optional device list — frames are
    placed round-robin across them (results are independent of placement).
    """
    import jax

    stacks = [
        LabeledStack.from_array(
            img, voxelsize=voxelsize or getattr(img, "voxelsize", None),
            background=background,
        )
        for img in images
    ]
    bucket_by_shape: Dict[tuple, int] = {}
    for s in stacks:
        key = s.shape
        bucket_by_shape[key] = max(bucket_by_shape.get(key, 0), _bucket(s.n_labels))

    devs = list(devices) if devices else [None]
    placed: List[LabeledStack] = []
    for i, s in enumerate(stacks):
        dev = devs[i % len(devs)]
        if dev is not None:
            s = LabeledStack(
                dense=jax.device_put(s.dense, dev),
                ids=s.ids,
                voxelsize=s.voxelsize,
                background_segment=s.background_segment,
            )
        placed.append(s)

    # frames run in sequence: each ends in a host readback before the next
    # is dispatched, so frames placed on different devices do not overlap
    tables: List[FeatureTable] = []
    for s in placed:
        if s.ndim != 3:
            tables.append(analyze_stack(s))
        else:
            tables.append(
                analyze_stack_blocked(s, n_bucket=bucket_by_shape[s.shape])
            )
    return tables


def graph_series(
    images: Sequence,
    background: int = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
    **graph_kwargs,
) -> List[PropertyGraph]:
    """Per-timepoint cell property graphs (one fused pass per frame)."""
    tables = analyze_series(
        images, background=background, voxelsize=voxelsize, devices=devices
    )
    return [
        graph_from_table(t, background=background, **graph_kwargs)
        for t in tables
    ]


def temporal_graph_from_images(
    images: Sequence,
    lineages: Optional[Sequence[Dict]] = None,
    background: int = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
    **graph_kwargs,
) -> TemporalPropertyGraph:
    """Full temporal pipeline: images + lineage maps → lineage-linked graph.

    ``lineages[t]`` maps a mother label at timepoint t to its daughter
    label(s) at t+1 (the MARS-ALT lineage format the reference consumes).
    """
    graphs = graph_series(
        images,
        background=background,
        voxelsize=voxelsize,
        devices=devices,
        **graph_kwargs,
    )
    tpg = TemporalPropertyGraph()
    tpg.extend(graphs, lineages)
    return tpg
