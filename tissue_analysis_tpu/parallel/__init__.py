from tissue_analysis_tpu.parallel.sharded import (  # noqa: F401
    analyze_sharded,
    analyze_sharded_blocked,
    analyze_sharded_chunked,
    make_mesh,
    sharded_pipeline,
)
