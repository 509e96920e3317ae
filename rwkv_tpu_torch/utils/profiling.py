"""Tracing and profiling: ``torch.profiler`` in place of the reference's
gprof build flag and the tools' per-step wall-clock prints.

Ports ``rwkv_tpu.utils.profiling``:

- ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
  (CPU activity and, where a card is present, CUDA's) that writes a Chrome
  trace (Perfetto, ``chrome://tracing``) into `log_dir`;
- ``annotate(name)``: a named region of the timeline
  (``torch.profiler.record_function``);
- ``force_sync(x)``: waits for the device work behind `x`;
- ``StepTimer``: per-step wall-clock statistics, synchronised.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

DEFAULT_TRACE_DIR = Path(tempfile.gettempdir()) / "rwkv_tpu_torch_trace"


@dataclass
class Trace:
    """What ``trace`` yields: the profiler (``profiler.events()``,
    ``key_averages()``) and, once the block has ended, the Chrome trace's
    path (None when no `log_dir` was given)."""

    profiler: torch.profiler.profile
    path: Optional[Path] = None


@contextlib.contextmanager
def trace(log_dir: Optional[str] = DEFAULT_TRACE_DIR):
    """Profile the block: CPU activity and, with a card, CUDA kernels and
    copies; the device is synchronised before the profiler stops. Writes
    a new ``trace-*.json`` into `log_dir` (made if missing; None writes
    nothing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        out = Trace(prof)
        yield out
        if cuda:
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="trace-", suffix=".json", dir=log_dir)
        os.close(fd)
        out.path = Path(path)
        prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


def _first_leaf(x):
    while _is_tree(x):
        leaves = list(x.values()) if isinstance(x, dict) else list(x)
        if not leaves:
            return None
        x = leaves[0]
    return x


def force_sync(x) -> None:
    """Wait for the device work feeding `x`: a tensor, or a dict, list or
    tuple of them (its first leaf's device). Host values need nothing."""
    leaf = _first_leaf(x)
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def _is_tree(x) -> bool:
    return isinstance(x, (dict, list, tuple))


@dataclass
class StepTimer:
    """Accumulates per-step latencies; prints ms/token statistics like the
    reference tools (generate_completions.py:57-71)."""

    sync: bool = True
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self.sync and result is not None:
            force_sync(result)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))

    @property
    def count(self) -> int:
        return len(self._times)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self._times) * 1e3) if self._times else 0.0

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self._times, 50) * 1e3) if self._times else 0.0

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self._times, 99) * 1e3) if self._times else 0.0

    def summary(self) -> str:
        return (
            f"{self.count} steps: mean {self.mean_ms:.3f} ms, "
            f"p50 {self.p50_ms:.3f} ms, p99 {self.p99_ms:.3f} ms, "
            f"{1000.0 / self.mean_ms if self.mean_ms else 0:.1f} steps/s"
        )
