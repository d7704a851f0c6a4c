"""tissue_analysis_tpu — accelerator-native 3D tissue morphometrics.

A ground-up JAX/XLA rebuild of the capabilities of
``VirtualPlants/tissue_analysis`` (``vplants.tissue_analysis``): per-cell
feature extraction (volume, barycenter, bounding box, inertia axes),
cell-adjacency / wall-surface analysis, epidermis (L1) and border-cell
detection, and cell property-graph export over segmented (labeled) voxel
stacks — replacing the reference's per-label ``scipy.ndimage`` loops with two
fused device sweeps:

1. a **segment-moment sweep** (counts, Σcoord, Σcoord², coordinate min/max per
   label) computed with exact integer arithmetic so float results bit-match
   the scipy reference semantics, and
2. a **6/26-connectivity stencil sweep** emitting the complete cell-adjacency
   graph and per-wall voxel/area tables in one pass.

Reference parity citations use symbol granularity
(``spatial_image_analysis.py :: Symbol``) per SURVEY.md §0 — the reference
mount was empty this session, so no line numbers exist to cite.

Public entry points:

- :func:`tissue_analysis_tpu.analyze` — one-call fused analysis returning a
  :class:`~tissue_analysis_tpu.features.table.FeatureTable`.
- :class:`tissue_analysis_tpu.SpatialImageAnalysis` — reference-compatible
  facade (``volume``/``neighbors``/``cell_wall_surface``/``inertia_axis``/…).
- :func:`tissue_analysis_tpu.graph_from_image` — cell property-graph export.
"""

from tissue_analysis_tpu.core.spatial_image import (  # noqa: F401
    SpatialImage,
    imread,
    imsave,
)
from tissue_analysis_tpu.core.stack import LabeledStack  # noqa: F401
from tissue_analysis_tpu.engine import analyze, analyze_raw  # noqa: F401
from tissue_analysis_tpu.features.table import FeatureTable  # noqa: F401
from tissue_analysis_tpu.analysis import (  # noqa: F401
    DICT,
    LIST,
    NPLIST,
    AbstractSpatialImageAnalysis,
    AnalysisConfig,
    SpatialImageAnalysis,
    SpatialImageAnalysis2D,
    SpatialImageAnalysis3D,
    SpatialImageAnalysis3DS,
)
from tissue_analysis_tpu.graph import (  # noqa: F401
    PropertyGraph,
    TemporalPropertyGraph,
    dividing_cells,
    division_asymmetry,
    division_events,
    division_rate,
    exist_all_relative_at_rank,
    exist_relative_at_rank,
    graph_from_image,
    graph_from_table,
    lineage_vertices,
    lineage_volumes,
    nb_descendants,
    per_lineage_aggregate,
    relative_temporal_change,
    sibling_cells,
    temporal_change,
    temporal_rate,
    time_point_property,
)
from tissue_analysis_tpu.streaming import (  # noqa: F401
    ArraySource,
    TiledSource,
    analyze_streamed,
)
from tissue_analysis_tpu.series import (  # noqa: F401
    analyze_series,
    graph_series,
    temporal_graph_from_images,
)

__version__ = "0.1.0"
