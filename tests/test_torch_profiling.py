"""The port's ``utils.profiling`` on the CPU: ``trace`` writes a Chrome
trace holding an ``annotate`` region's name; ``StepTimer`` gives the
statistics and ``summary`` of the JAX package's on the same step times;
``force_sync`` takes a tensor, a dict, a list or a tuple."""

import json

import numpy as np
import pytest
import torch

from rwkv_tpu.utils import profiling as JP
from rwkv_tpu_torch.utils import profiling as TP


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.randn(64, 64)
    with TP.trace(tmp_path / "traces") as tr:
        with TP.annotate("reservoir_region"):
            y = x @ x
        TP.force_sync(y)
    assert tr.path is not None and tr.path.parent == tmp_path / "traces"
    events = json.loads(tr.path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "reservoir_region" in names
    assert any(e.name == "reservoir_region" for e in tr.profiler.events())


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with TP.trace(None) as tr:
        torch.ones(4).sum()
    assert tr.path is None and not list(tmp_path.iterdir())
    # a second trace in the same directory gets a file of its own
    with TP.trace(tmp_path) as a:
        pass
    with TP.trace(tmp_path) as b:
        pass
    assert a.path != b.path and a.path.exists() and b.path.exists()


@pytest.mark.parametrize("times", [[0.0021, 0.0019, 0.0030, 0.0018, 0.0052], [0.25], []])
def test_step_timer_statistics_match_jax(times):
    t, j = TP.StepTimer(), JP.StepTimer()
    t._times, j._times = list(times), list(times)
    assert (t.count, t.mean_ms, t.p50_ms, t.p99_ms) == (j.count, j.mean_ms, j.p50_ms, j.p99_ms)
    assert t.summary() == j.summary()


def test_step_timer_times_steps():
    timer = TP.StepTimer()
    for _ in range(3):
        with timer.step() as out:
            out["result"] = {"logits": torch.ones(8) * 2}
    timer.start()
    dt = timer.stop(torch.zeros(2))
    assert timer.count == 4 and dt >= 0 and timer.mean_ms >= 0
    assert timer.summary().startswith("4 steps: mean ")
    assert not TP.StepTimer(sync=False).sync


@pytest.mark.parametrize("tree", [
    torch.ones(3),
    {"a": torch.ones(2), "b": [torch.zeros(1)]},
    [torch.ones(2), torch.ones(3)],
    (torch.ones(1),),
    {"nested": ({"x": torch.ones(1)},)},
    np.ones(3),
    [],
    {},
])
def test_force_sync_takes_tensors_and_trees(tree):
    assert TP.force_sync(tree) is None
    assert TP._first_leaf({"k": [tree]}) is TP._first_leaf(tree)
