"""No float32 matrix product on the sweep path may run at DEFAULT precision.

On GPUs with tensor cores a DEFAULT-precision f32 product may run in TF32,
which holds integers exactly only up to 2¹¹ — a float one-hot id lookup
would then silently route labels above 2048 to the wrong pair. The CPU
cannot show that rounding, so these tests read the traced programs instead:
every f32 ``dot_general`` of the resident, 2D-lifted, streamed-slab,
sharded-slab and seam programs must ask for HIGHEST precision (or none may
remain), and ``_compact_pair_mats`` must return exact ids across the float
boundaries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tissue_analysis_tpu.ops import blocked

N_LABELS = 3000  # past 2^11: the label range the TF32 fault would corrupt
HIGHEST = jax.lax.Precision.HIGHEST


def _subjaxprs(param):
    if hasattr(param, "eqns"):
        yield param
    elif hasattr(param, "jaxpr") and hasattr(param.jaxpr, "eqns"):
        yield param.jaxpr
    elif isinstance(param, (list, tuple)):
        for p in param:
            yield from _subjaxprs(p)


def _dots(jaxpr):
    """(operand dtypes, precision) of every dot_general, nested jaxprs too."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield [v.aval.dtype for v in eqn.invars], eqn.params["precision"]
        for p in eqn.params.values():
            for sub in _subjaxprs(p):
                yield from _dots(sub)


def _resident():
    fn, _ = blocked._build_sweep((40, 40, 40), N_LABELS, blocked.BlockConfig())
    return jax.make_jaxpr(fn)(jnp.zeros((40, 40, 40), jnp.uint16))


def _lifted_2d():
    cfg = blocked.BlockConfig(block=(1, 64, 256))
    fn, _ = blocked._build_sweep((1, 96, 300), N_LABELS, cfg)
    return jax.make_jaxpr(fn)(jnp.zeros((1, 96, 300), jnp.uint16))


def _streamed_slab():
    from tissue_analysis_tpu import streaming

    cfg = blocked.BlockConfig()
    shape = (32, 40, 40)
    wshift = blocked._check_static(shape, N_LABELS, cfg)
    prog = streaming._build_program_blocked(
        shape, N_LABELS, cfg, wshift, 3 * cfg.derived_max_pairs(N_LABELS)
    )
    return jax.make_jaxpr(prog)(
        jnp.zeros(shape, jnp.uint16), jnp.zeros((64, 64), jnp.int32)
    )


def _sharded_slab():
    from tissue_analysis_tpu.parallel import sharded

    cfg = blocked.BlockConfig()
    mesh = sharded.make_mesh(2)
    wshift = blocked._check_static((64, 40, 40), N_LABELS, cfg)
    max_entries = 3 * cfg.derived_max_pairs(N_LABELS)
    return jax.make_jaxpr(
        lambda d: sharded._blocked_sharded_pipeline(
            d, N_LABELS, cfg, wshift, 32, mesh, max_entries
        )
    )(jnp.zeros((64, 40, 40), jnp.uint16))


def _seam():
    cfg = blocked.BlockConfig()
    _, cross_seam = blocked._build_slab_fns(
        (32, 64, 64), N_LABELS, cfg,
        blocked._check_static((32, 64, 64), N_LABELS, cfg),
    )
    plane = jnp.zeros((64, 64), jnp.int32)
    return jax.make_jaxpr(cross_seam)(plane, plane)


@pytest.mark.parametrize(
    "program", [_resident, _lifted_2d, _streamed_slab, _sharded_slab, _seam],
    ids=["resident", "lifted_2d", "streamed_slab", "sharded_slab", "seam"],
)
def test_no_default_precision_f32_dot(program):
    dots = list(_dots(program().jaxpr))
    assert dots, "walker found no dot_general at all"
    for dtypes, precision in dots:
        if jnp.float32 in dtypes:
            assert precision in (HIGHEST, (HIGHEST, HIGHEST)), (dtypes, precision)


@pytest.mark.parametrize(
    "big_ids",
    [
        (2**11 - 1, 2**11 + 1),
        (2**12 + 1,),
        (2**16 + 1,),
        (2**20 + 1,),
        (2**24 - 1,),
    ],
    ids=["2^11+-1", "2^12+1", "2^16+1", "2^20+1", "2^24-1"],
)
def test_compact_pair_mats_exact_ids(big_ids):
    """Slot -> global id lookup is exact on both sides of every float
    boundary: each big id walls a small id and its big neighbour."""
    imax = int(blocked._IMAX)
    ids = sorted({2, 3, *big_ids, *(b + 1 for b in big_ids)})
    L = 8
    row = np.full((1, L), imax, np.int32)
    row[0, : len(ids)] = ids
    mats = np.zeros((1, L, L), np.int32)
    want = {}
    for k, a in enumerate(ids):
        for m, b in enumerate(ids):
            if a < b and (a in (2, 3) or b == a + 1):
                mats[0, k, m] = 7 + k + m
                want[(a, b)] = 7 + k + m
    # a wall with the pad slot must be dropped
    mats[0, 0, L - 1] = 5
    lo, hi, ct, ovf, _ = blocked._compact_pair_mats(
        jnp.asarray(mats), jnp.asarray(row), jnp.asarray(row),
        max(ids) + 2, L * L,
    )
    lo, hi, ct = (np.asarray(v) for v in (lo, hi, ct))
    live = lo < imax
    got = {(int(a), int(b)): int(c) for a, b, c in zip(lo[live], hi[live], ct[live])}
    assert got == want
    assert not bool(np.asarray(ovf).any())
