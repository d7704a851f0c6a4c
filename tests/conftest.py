"""Test config: force the CPU backend with 8 virtual devices BEFORE jax
imports, so sharding tests run everywhere (SURVEY.md §4 item 3)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_cpu_state():
    """Bound accumulated XLA CPU runtime state across the long suite.

    A full run compiles thousands of distinct executables; late in the
    suite fresh compiles started dying (SIGABRT/segfault inside
    backend_compile — observed twice, in different test files, always
    >45 min in, never in isolation). Dropping compiled-executable caches
    once the process map count grows large keeps the runtime well away
    from that state at the cost of a few recompiles.
    """
    yield
    try:
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
    except OSError:
        return
    if n_maps > 20000:
        jax.clear_caches()

from tissue_analysis_tpu.core.synthetic import (  # noqa: E402
    single_cube_image,
    two_slab_image,
    voronoi_stack,
)


@pytest.fixture(scope="session")
def small3d():
    """32³ Voronoi stack, ~40 cells, anisotropic voxels, sphere background."""
    return voronoi_stack((32, 32, 32), 40, seed=0, voxelsize=(2.0, 0.5, 0.5))


@pytest.fixture(scope="session")
def small3d_iso():
    return voronoi_stack((24, 28, 26), 25, seed=3)


@pytest.fixture(scope="session")
def small2d():
    return voronoi_stack((48, 40), 20, seed=1, voxelsize=(0.75, 1.25))


@pytest.fixture(scope="session")
def cube():
    return single_cube_image()


@pytest.fixture(scope="session")
def slabs():
    return two_slab_image()


@pytest.fixture(scope="session")
def gapped():
    """Stack with non-contiguous label ids (tests missing-label handling)."""
    img = np.asarray(voronoi_stack((16, 16, 16), 10, seed=2)).astype(np.int64)
    img[img > 1] += 100  # ids 101.. with gaps below
    img[img == 105] = 900  # a big gap
    from tissue_analysis_tpu.core.spatial_image import SpatialImage

    return SpatialImage(img, voxelsize=(1.0, 1.0, 1.0))
