"""Multi-device dryrun body — runs the full z-slab-sharded pipeline on a
virtual CPU mesh and asserts bit-equality against the single-device engine.

This module is executed in a fresh subprocess by ``__graft_entry__.
dryrun_multichip`` (JAX fixes its platform and device count at first
initialization). It forces the CPU backend and the virtual device count
itself, before JAX is imported, so it is also correct when invoked directly
(``python -m tissue_analysis_tpu.parallel.dryrun 8``).

Parity target: the sharding-equivalence spec, SURVEY.md §4 item 3.
"""

from __future__ import annotations

import os
import sys


def run(n_devices: int) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    import numpy as np

    from tissue_analysis_tpu.core.stack import LabeledStack
    from tissue_analysis_tpu.core.synthetic import voronoi_stack
    from tissue_analysis_tpu.engine import analyze_stack
    from tissue_analysis_tpu.parallel.sharded import (
        analyze_sharded_blocked,
        analyze_sharded_chunked,
        make_mesh,
    )

    devs = jax.devices()
    assert len(devs) >= n_devices, (
        f"expected >= {n_devices} devices, got {len(devs)}: {devs}"
    )
    assert devs[0].platform == "cpu", f"dryrun must run on cpu, got {devs[0]}"

    # z extent deliberately NOT divisible by n_devices: exercises pad path
    img = voronoi_stack((30, 24, 24), 25, seed=3)
    stack = LabeledStack.from_array(np.asarray(img), background=1)
    mesh = make_mesh(n_devices)
    t_single = analyze_stack(stack)

    def check(t_sharded, name):
        for field in (
            "count", "s1", "s2", "cmin", "cmax",
            "pair_lo", "pair_hi", "wall_face_counts", "margin",
        ):
            a = getattr(t_sharded, field)
            b = getattr(t_single, field)
            assert np.array_equal(a, b), f"{name}: {field} mismatch"

    # both sharded engines: blocked (matmul/sort) and chunked (segment scan)
    check(analyze_sharded_blocked(stack, mesh=mesh), "blocked")
    check(analyze_sharded_chunked(stack, mesh=mesh), "chunked")

    # case 2 (VERDICT r3 weak #5): a few hundred cells over 8 devices with
    # 32-plane blocks (z=120 -> slab_z=32: four slabs of cells, three seams
    # with real cell crossings, four all-pad slabs) — covering seam dedup
    # and buffer convergence under load, not just the toy pad path.
    img2 = voronoi_stack((120, 16, 128), 400, seed=7, sphere=False)
    stack2 = LabeledStack.from_array(np.asarray(img2), background=1)
    t2_single = analyze_stack(stack2)

    def check2(t_sharded, name):
        for field in (
            "count", "s1", "s2", "cmin", "cmax",
            "pair_lo", "pair_hi", "wall_face_counts", "margin",
        ):
            assert np.array_equal(
                getattr(t_sharded, field), getattr(t2_single, field)
            ), f"case2 {name}: {field} mismatch"

    check2(analyze_sharded_blocked(stack2, mesh=mesh), "blocked")
    # blocked with deliberately tiny pair buffers: the overflow-retry
    # (rerun-larger) loop must converge and still bit-match
    import dataclasses

    from tissue_analysis_tpu.ops import blocked as _blocked

    tiny = dataclasses.replace(
        _blocked.BlockConfig(), max_pairs_per_block=8
    )
    check2(analyze_sharded_blocked(stack2, mesh=mesh, cfg=tiny), "blocked-tinybuf")

    # case 3 (VERDICT r4 next #8): the STREAMED out-of-core path at a
    # wide-ish aspect ratio (cross-section ≫ slab_z — the shape class whose
    # Gvox-scale compile pathology bit round 4), with the two-key sort
    # branch FORCED (n_labels withheld so the packed-key fast path cannot
    # hide the two-key composition — at real Gvox widths n > 23k disables
    # packing). Wired to the driver signal so regressions in the per-slab
    # two-key sort-reduce composition surface every round, not only in
    # scripts.
    from tissue_analysis_tpu import streaming

    img3 = voronoi_stack((32, 192, 192), 150, seed=11, sphere=False)
    stack3 = LabeledStack.from_array(np.asarray(img3), background=1)
    t3_single = analyze_stack(stack3)
    orig_reduce = _blocked._sorted_pair_reduce

    def force_twokey(los, his, tags, counts, max_entries, n_labels=None, **kw):
        return orig_reduce(los, his, tags, counts, max_entries, **kw)

    _blocked._sorted_pair_reduce = force_twokey
    streaming.blocked._sorted_pair_reduce = force_twokey
    try:
        t3 = streaming.analyze_streamed(
            np.asarray(img3), background=1, slab_z=8, engine="blocked"
        )
    finally:
        _blocked._sorted_pair_reduce = orig_reduce
        streaming.blocked._sorted_pair_reduce = orig_reduce
    for field in (
        "count", "s1", "s2", "cmin", "cmax",
        "pair_lo", "pair_hi", "wall_face_counts", "margin",
    ):
        assert np.array_equal(
            getattr(t3, field), getattr(t3_single, field)
        ), f"case3 streamed-wide: {field} mismatch"

    print(
        f"dryrun_multichip ok: {n_devices} devices, all engines bit-equal "
        f"(case1 25 cells pad-path; case2 {stack2.n_labels} labels, "
        f"multi-block slabs + seam load + overflow retry; case3 streamed "
        f"wide-aspect {stack3.n_labels} labels, forced two-key sort)"
    )


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
