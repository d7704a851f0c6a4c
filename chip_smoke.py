"""Prove the fused analysis pass on the GPU through its public entry points.

Run from the repository root, on a machine with a GPU:

    python chip_smoke.py [--seed 1]      # one card, phases 0-5
    python chip_smoke.py --four-cards    # four cards: the multi-device
                                         # paths and what they are compared
                                         # with, nothing else

One card, every phase at full size:

0. device — JAX version and devices, the card's name and power limit, the
   compile-cache directory and XLA_FLAGS; exits non-zero unless JAX's
   platform is ``gpu``.
1. resident — a 512³ Voronoi tissue stack (3,500 seeds, ~2,031 labels,
   background 1) through ``analyze`` → ``graph_from_table``.
2. many labels — a 512³ stack with ≥ 17,000 labels (segment ids cross 2¹¹
   and 2¹⁴, raw ids cross 2¹⁵) through ``analyze`` and ``analyze_raw``.
3. 2D — a 4096² image through ``analyze`` (the z-lifted blocked engine).
4. series — 3 frames of 512³ (cells divide between frames, with the lineage
   map) through ``analyze_series`` and ``temporal_graph_from_images``.
5. streamed — the phase-1 stack through ``analyze_streamed`` (slab_z=128).

Correctness. Phases 1-3 compare every integer of the FeatureTable (ids,
counts, coordinate sums, second moments, bounding boxes, the wall COO with
per-axis face counts, margins) exactly with the plain reference
(``ScipyOracle.feature_table``: numpy bincounts and sorts over the voxels,
independent of the device code). The only float outputs — barycenters,
inertia axes and wall areas — are computed on the host in float64 by
``features/finalize.py`` from those integers, so they are compared bit for
bit too. Phase 4 compares each frame with its own ``analyze``; phase 5 with
the phase-1 resident table; ``--four-cards`` compares ``analyze_sharded``
(1024³, ~16k labels, a 4-card z-mesh) and a 4-card ``analyze_series`` with
the single-card results, and the single-card 1024³ table with the reference.

Each phase prints one line: name, shape, labels, walls, first-call and warm
seconds (host clock, host array in → table and graph out), ``ok``. The last
line is the JSON object ``{"ok": true, "device": {...}}``; on any failure
the script exits non-zero and prints no such line. It runs in one process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BACKGROUND = 1
SIZE = 512                # phases 1, 2, 4, 5: cube edge
CELLS = 3500              # phase 1 Voronoi seeds (the bench stack)
MANY_CELLS = 35000        # phase 2 seeds: ~17,900 labels inside the sphere
MANY_MIN_LABELS = 17000
MANY_SEED_OFFSET = 6      # --seed 1 gives the seed-7 many-label stack
SIZE_2D = 4096
CELLS_2D = 4000
FRAMES = 3
DIVIDE_FRACTION = 0.1     # cells that divide between consecutive frames
SLAB_Z = 128
FOUR_TILES = 2            # --four-cards: 2x2x2 tiles of the SIZE stack
FOUR_FRAMES = 4
FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def last_line(device: dict) -> str:
    """The contract line: ok plus JAX's platform, device kind and count."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": device["count"],
            },
        }
    )


def say(*parts) -> None:
    print(*parts, flush=True)


def check_equal(got, ref, what: str) -> None:
    """Exact equality of two FeatureTables: integers and the host floats."""
    if got.background_segment != ref.background_segment:
        raise AssertionError(f"{what}: background_segment differs")
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: field {f} differs")
    floats = (
        ("barycenter", lambda t: t.barycenter()),
        ("inertia_values", lambda t: t.inertia_axes()[0]),
        ("inertia_vectors", lambda t: t.inertia_axes()[1]),
        ("wall_areas", lambda t: t.wall_areas()),
    )
    for name, fn in floats:
        if not np.array_equal(fn(got), fn(ref), equal_nan=True):
            raise AssertionError(f"{what}: {name} differs")


def phase_line(name, shape, table, first_s, warm_s, **extra) -> None:
    fields = [
        f"phase={name}",
        "shape=" + "x".join(str(s) for s in shape),
        f"labels={table.n_labels}",
        f"walls={table.n_pairs}",
        f"first_s={first_s:.4f}",
        f"warm_s={warm_s:.4f}",
    ]
    fields += [f"{k}={v}" for k, v in extra.items()]
    say(" ".join(fields + ["ok"]))


def timed(fn, runs: int):
    """Call ``fn`` ``runs`` times; (last result, first seconds, last seconds).

    The first call compiles and discovers buffer sizes, the second compiles
    the converged configuration, so the third is the first warm one."""
    times = []
    out = None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, times[0], times[-1]


def voronoi(shape, cells, seed) -> np.ndarray:
    from tissue_analysis_tpu.core.synthetic import voronoi_stack

    return np.asarray(voronoi_stack(shape, cells, seed=seed))


def reference(img, workers):
    from tissue_analysis_tpu.oracle.scipy_oracle import ScipyOracle

    return ScipyOracle(img, background=BACKGROUND).feature_table(workers)


def divide(img: np.ndarray, fraction: float, rng):
    """Next frame: a random ``fraction`` of the cells divides at the middle
    z-plane of its bounding box (the lower part takes a new label).
    Returns (frame, lineage {mother: [daughters]})."""
    import scipy.ndimage as nd

    boxes = nd.find_objects(img)
    cells = np.asarray(
        [lab for lab, b in enumerate(boxes, start=1)
         if b is not None and lab != BACKGROUND]
    )
    chosen = rng.choice(cells, size=int(len(cells) * fraction), replace=False)
    top = int(img.max())
    mid = np.full(top + 1, -1, np.int64)
    new = np.arange(top + 1, dtype=np.int64)
    for k, lab in enumerate(sorted(chosen)):
        zs = boxes[lab - 1][0]
        mid[lab] = (zs.start + zs.stop) // 2
        new[lab] = top + 1 + k
    z = np.arange(img.shape[0]).reshape(-1, 1, 1)
    lower = z < mid[img]
    out = img.copy()
    out[lower] = new[img[lower]]
    lineage = {int(c): [int(c)] for c in cells}
    for lab in chosen:
        lineage[int(lab)].append(int(new[lab]))
    return out.astype(img.dtype), lineage


def series_frames(base: np.ndarray, count: int, seed: int):
    rng = np.random.default_rng(seed)
    frames, lineages = [base], []
    for _ in range(count - 1):
        nxt, lin = divide(frames[-1], DIVIDE_FRACTION, rng)
        frames.append(nxt)
        lineages.append(lin)
    return frames, lineages


def one_card(seed: int, workers: int) -> None:
    from tissue_analysis_tpu import (
        analyze,
        analyze_raw,
        analyze_series,
        analyze_streamed,
        graph_from_table,
        temporal_graph_from_images,
    )

    def analyze_graph(img):
        def run():
            t = analyze(img, background=BACKGROUND)
            graph_from_table(t)
            return t
        return run

    # ---- phase 1: resident, main width
    img = voronoi((SIZE,) * 3, CELLS, seed)
    ref = reference(img, workers)
    table, first, warm = timed(analyze_graph(img), 3)
    check_equal(table, ref, "resident")
    phase_line("resident", img.shape, table, first, warm)
    resident = table

    # ---- phase 2: many labels (ids past 2^11, 2^14; raw ids past 2^15)
    many = voronoi((SIZE,) * 3, MANY_CELLS, seed + MANY_SEED_OFFSET)
    ref = reference(many, workers)
    if ref.n_labels < MANY_MIN_LABELS:
        raise AssertionError(f"many-label stack has {ref.n_labels} labels")
    table, first, warm = timed(analyze_graph(many), 3)
    check_equal(table, ref, "many labels (analyze)")
    phase_line("many_labels", many.shape, table, first, warm,
               max_raw_id=int(ref.ids.max()))
    table, first, warm = timed(
        lambda: analyze_raw(many, background=BACKGROUND), 3
    )
    check_equal(table, ref, "many labels (analyze_raw)")
    phase_line("many_labels_raw", many.shape, table, first, warm)
    del many

    # ---- phase 3: 2D
    img2 = voronoi((SIZE_2D,) * 2, CELLS_2D, seed)
    ref = reference(img2, workers)
    table, first, warm = timed(analyze_graph(img2), 3)
    check_equal(table, ref, "2D")
    phase_line("image_2d", img2.shape, table, first, warm)
    del img2

    # ---- phase 4: series with lineage
    frames, lineages = series_frames(img, FRAMES, seed)
    tables = analyze_series(frames, background=BACKGROUND)
    for k, (frame, t) in enumerate(zip(frames, tables)):
        check_equal(t, analyze(frame, background=BACKGROUND), f"frame {k}")

    def temporal():
        return temporal_graph_from_images(
            frames, lineages, background=BACKGROUND
        )

    tpg, first, warm = timed(temporal, 2)
    cells = [set(t.ids.tolist()) - {BACKGROUND} for t in tables]
    want_v = sum(len(c) for c in cells)
    want_t = sum(
        len([d for d in ds if d in cells[k + 1]])
        for k, lin in enumerate(lineages)
        for m, ds in lin.items() if m in cells[k]
    )
    kinds = list(tpg.edge_property("edge_type").values())
    if tpg.nb_vertices() != want_v or kinds.count("t") != want_t:
        raise AssertionError(
            f"temporal graph: {tpg.nb_vertices()} vertices / "
            f"{kinds.count('t')} lineage edges, want {want_v} / {want_t}"
        )
    phase_line("series", (FRAMES,) + img.shape, tables[-1], first, warm,
               vertices=want_v, lineage_edges=want_t)
    del frames, tables, tpg

    # ---- phase 5: streamed
    table, first, warm = timed(
        lambda: analyze_streamed(img, background=BACKGROUND, slab_z=SLAB_Z), 2
    )
    check_equal(table, resident, "streamed")
    phase_line("streamed", img.shape, table, first, warm, slab_z=SLAB_Z)


def tile(base: np.ndarray, t: int) -> np.ndarray:
    """t³ tiling of ``base``; tile k's cells get ids offset by k·(cells)
    (the background is shared), so every tile holds distinct cells."""
    cells = int(base.max()) - BACKGROUND
    if BACKGROUND + t**3 * cells >= 1 << 16:
        raise ValueError("tiled labels must fit uint16")
    s = base.shape[0]
    out = np.empty((s * t,) * 3, np.uint16)
    inside = base != BACKGROUND
    for k, (z, y, x) in enumerate(np.ndindex(t, t, t)):
        part = base.astype(np.uint16)
        part[inside] += np.uint16(k * cells)
        out[z * s:(z + 1) * s, y * s:(y + 1) * s, x * s:(x + 1) * s] = part
    return out


def four_cards(seed: int, workers: int) -> None:
    import jax

    from tissue_analysis_tpu import analyze_series
    from tissue_analysis_tpu.core.stack import LabeledStack
    from tissue_analysis_tpu.engine import analyze_stack
    from tissue_analysis_tpu.parallel import analyze_sharded, make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]

    base = voronoi((SIZE,) * 3, CELLS, seed)
    big = tile(base, FOUR_TILES)
    ref = reference(big, workers)
    stack = LabeledStack.from_array(big, background=BACKGROUND)
    single, first, warm = timed(lambda: analyze_stack(stack), 3)
    check_equal(single, ref, "single card 1024^3")
    phase_line("single_card", big.shape, single, first, warm)
    del ref

    mesh = make_mesh(4)
    sharded, first, warm = timed(lambda: analyze_sharded(stack, mesh=mesh), 3)
    check_equal(sharded, single, "analyze_sharded")
    # every card must have held its slab, not only the first
    slab_bytes = big.nbytes // 4
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devs]
    if devs[0].platform == "gpu" and min(peaks) < slab_bytes:
        raise AssertionError(f"peak bytes per card {peaks} < slab {slab_bytes}")
    phase_line("sharded", big.shape, sharded, first, warm,
               cards=len(devs), peak_gb="/".join(f"{p / 2**30:.2f}" for p in peaks))
    del stack, sharded, single, big

    frames, _ = series_frames(base, FOUR_FRAMES, seed)
    want = analyze_series(frames, background=BACKGROUND)
    got, first, warm = timed(
        lambda: analyze_series(frames, background=BACKGROUND, devices=devs), 2
    )
    for k, (a, b) in enumerate(zip(got, want)):
        check_equal(a, b, f"4-card series frame {k}")
    phase_line("series_4cards", (FOUR_FRAMES,) + base.shape, got[-1], first,
               warm, cards=len(devs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded and series paths")
    args = ap.parse_args(argv)

    import jax

    from tissue_analysis_tpu.utils.device import (
        describe_device,
        enable_compile_cache,
        require_gpu,
    )

    # ---- phase 0: device
    cache = enable_compile_cache()
    dev = describe_device()
    say(f"phase=device jax={jax.__version__} devices={jax.devices()}")
    say(f"device_kind={dev['kind']} platform={dev['platform']} "
        f"count={dev['count']}")
    say(f"compile_cache={cache} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    require_gpu()
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(args.seed, workers)
    else:
        one_card(args.seed, workers)
    say(f"total_s={time.perf_counter() - t0:.1f}")
    # the card's name and power limit, as nvidia-smi gives them
    if dev["nvidia_smi"] is None:
        raise RuntimeError("nvidia-smi gave no name and power limit")
    say(dev["nvidia_smi"])
    print(last_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
