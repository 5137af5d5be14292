"""Stage profiler and device traces.

A copy of orb_slam2_test_tpu/utils/profiling.py on torch.profiler in
place of jax.profiler. The reference's only timing is the per-frame
wall clock its example mains print at exit; this module adds:

  profiler            -- the module-level StageProfiler; the Tracker
                         marks its stages with `with profiler.span(name)`
                         (a no-op unless enabled)
  StageProfiler.report() -- per-stage count / total / mean / median /
                         p90 of host wall-clock time
  device_trace(dir)   -- context manager around torch.profiler.profile:
                         host operators, and the card's kernels when the
                         engine runs there, exported as a Chrome trace
                         (chrome://tracing, Perfetto)
  annotate(name)      -- torch.profiler.record_function, so that host
                         stage names show on the trace's timeline

Spans are host wall-clock and never synchronize the card: a span on the
card measures the dispatch of its stage plus whatever host sync falls
inside it (the frame's one readback, a keyframe flush). The device time
of the same frames is in the trace.

Enable it with `profiler.enable()` or the environment variable
ORB_TPU_PROFILE=1 (the JAX package's name, so that one setting serves
both packages).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


class StageProfiler:
    """Named wall-clock span accumulator.

    Spans may nest; each span is attributed to its own name only (no
    exclusive/inclusive split: the engine's stages are sequential)."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("ORB_TPU_PROFILE", "") not in ("", "0", "false")
        self.enabled = enabled
        self._samples: dict[str, list[float]] = {}

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        self._samples.clear()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        if self.enabled:
            self._samples.setdefault(name, []).append(seconds)

    def report(self) -> dict[str, dict]:
        """{stage: {count, total_s, mean_s, median_s, p90_s}} sorted by
        total time, largest first."""
        out = {}
        for name, xs in self._samples.items():
            s = sorted(xs)
            n = len(s)
            out[name] = {
                "count": n,
                "total_s": sum(s),
                "mean_s": sum(s) / n,
                "median_s": s[n // 2],
                "p90_s": s[min(n - 1, int(0.9 * n))],
            }
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_s"]))

    def format_report(self) -> str:
        rows = [
            f"{'stage':<28}{'count':>7}{'total ms':>12}{'mean ms':>10}"
            f"{'median ms':>11}{'p90 ms':>10}"
        ]
        for name, r in self.report().items():
            rows.append(
                f"{name:<28}{r['count']:>7}{r['total_s'] * 1e3:>12.1f}"
                f"{r['mean_s'] * 1e3:>10.2f}{r['median_s'] * 1e3:>11.2f}"
                f"{r['p90_s'] * 1e3:>10.2f}"
            )
        return "\n".join(rows)


#: the module-level profiler the engine's stages report into
profiler = StageProfiler()


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: bool | None = None):
    """Trace the enclosed window with torch.profiler and write it to
    `log_dir`/trace.json (Chrome trace format). `cuda`: record the
    card's kernels too; None records them when a card is available.
    Yields the torch.profiler.profile object. Wrap a short window, not a
    whole run: traces are large."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"device trace written to {path}")


def annotate(name: str):
    """A host-side range that shows on the trace's timeline (a no-op
    outside a trace)."""
    return torch.profiler.record_function(name)
