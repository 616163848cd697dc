"""Standing per-stage timing accumulators of the threaded pipeline.

Copy of stella_vslam_tpu/util/perf.py. The reference publishes per-frame
extraction and tracking wall times (system.cc:540-543,578-583;
frame_publisher.h:107-112). Every stage of the threaded System records into
one process-global accumulator: the caller thread's feed and its waits on
the pipeline bounds ("feed/"), the finalize thread ("fin/"), the mapping
thread's keyframe events ("map/") and local BAs ("ba/"), and the loop
thread's events ("loop/"), so a run can print where its host time goes.
Host wall time matters twice here: the threads share the interpreter's
lock, so a millisecond of Python on any of them is taken from the others.

Overhead: one monotonic() pair and a dict update per segment (~1 us);
always on.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class PerfAccumulator:
    def __init__(self):
        self._lock = threading.Lock()
        self._seg = {}  # name -> [count, total_s, max_s]

    def add(self, name: str, dt: float):
        with self._lock:
            s = self._seg.get(name)
            if s is None:
                self._seg[name] = [1, dt, dt]
            else:
                s[0] += 1
                s[1] += dt
                if dt > s[2]:
                    s[2] = dt

    @contextmanager
    def timer(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, time.monotonic() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: tuple(v) for k, v in self._seg.items()}

    def reset(self):
        with self._lock:
            self._seg.clear()

    def report(self, min_total_ms: float = 1.0) -> str:
        """Formatted budget table: name, count, total ms, mean ms, max ms —
        sorted by total descending, grouped by role prefix."""
        snap = self.snapshot()
        rows = [
            (k, c, tot * 1e3, tot * 1e3 / c, mx * 1e3)
            for k, (c, tot, mx) in snap.items()
            if tot * 1e3 >= min_total_ms
        ]
        rows.sort(key=lambda r: -r[2])
        if not rows:
            return "(no perf segments recorded)"
        w = max(len(r[0]) for r in rows)
        out = [f"{'segment':<{w}}  {'n':>6}  {'total ms':>9}  "
               f"{'mean':>7}  {'max':>7}"]
        for name, c, tot, mean, mx in rows:
            out.append(
                f"{name:<{w}}  {c:>6}  {tot:>9.0f}  {mean:>7.1f}  {mx:>7.1f}")
        return "\n".join(out)


PERF = PerfAccumulator()
