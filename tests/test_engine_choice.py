"""Engine names: only 'auto', 'blocked' and 'chunked' exist, and 'auto'
takes the blocked engine for 3D stacks and (z-lifted) 2D images."""

import numpy as np
import pytest

from tissue_analysis_tpu import engine
from tissue_analysis_tpu.core.stack import LabeledStack
from tissue_analysis_tpu.core.synthetic import voronoi_stack


@pytest.fixture(scope="module")
def stack3d():
    img = voronoi_stack((16, 16, 16), 8, seed=0)
    return LabeledStack.from_array(np.asarray(img), background=1)


def test_analyze_stack_rejects_pallas(stack3d):
    with pytest.raises(ValueError, match="engine"):
        engine.analyze_stack(stack3d, engine="pallas")


def test_analyze_streamed_rejects_pallas(stack3d):
    from tissue_analysis_tpu.streaming import analyze_streamed

    with pytest.raises(ValueError, match="engine"):
        analyze_streamed(np.asarray(stack3d.dense), engine="pallas")


def test_analyze_sharded_rejects_pallas(stack3d):
    from tissue_analysis_tpu.parallel import analyze_sharded, make_mesh

    with pytest.raises(ValueError, match="engine"):
        analyze_sharded(stack3d, mesh=make_mesh(2), engine="pallas")


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 20)], ids=["3d", "2d"])
def test_auto_picks_blocked(monkeypatch, shape):
    img = voronoi_stack(shape, 6, seed=1)
    stack = LabeledStack.from_array(np.asarray(img), background=1)
    calls = []
    monkeypatch.setattr(
        engine, "analyze_stack_blocked",
        lambda s, cfg=None, **kw: calls.append(("blocked", s.ndim)) or "b",
    )
    monkeypatch.setattr(
        engine, "analyze_stack_chunked",
        lambda *a, **kw: calls.append(("chunked",)) or "c",
    )
    assert engine.analyze_stack(stack) == "b"
    assert calls == [("blocked", len(shape))]
