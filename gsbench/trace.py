"""The profiler's trace of a run's traced window, read from the Chrome
trace that ``torch.profiler`` exports.

Device operations are the events of the categories in ``DEVICE_CATS``
(kernels, copies, fills). Each kernel is tied to the host call that
launched it by its correlation id, and so to the host spans open on that
thread at the launch: a span's device time is the time of the kernels
launched inside it, whichever stream runs them. The device's busy time is
the union of its operations' intervals inside the window (overlapping
streams counted once); an idle gap is named by the innermost host event
open at its start.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "gsbench.window"


class Trace:
    def __init__(self, events: list, window: str = WINDOW):
        host = collections.defaultdict(list)
        launches, device = {}, []
        win = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((e.get("name", ""), ts, dur,
                               (e.get("args") or {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("pid"), e.get("tid"), ts)
            elif cat in HOST_CATS:
                name = e.get("name", "")
                if name == window and win is None:
                    win = (ts, ts + dur)
                host[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, name))
        if win is None:
            raise ValueError(f"the trace holds no '{window}' span")
        self.window = win
        self.device = [d for d in device
                       if d[1] < win[1] and d[1] + d[2] > win[0]]
        self.launches = launches
        self.host = {k: sorted(v, key=lambda h: (h[0], -h[1]))
                     for k, v in host.items()}
        self._enclosing = None

    @classmethod
    def load(cls, path: str, window: str = WINDOW) -> Trace:
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data,
                   window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _spans_at(self, corr) -> tuple:
        """Names of the host events open on the launching thread when the
        operation of ``corr`` was launched."""
        if self._enclosing is None:
            self._enclosing = {}
            by_thread = collections.defaultdict(list)
            for c, (pid, tid, ts) in self.launches.items():
                by_thread[(pid, tid)].append((ts, c))
            for key, launches in by_thread.items():
                evs, stack, ei = self.host.get(key, []), [], 0
                for ts, c in sorted(launches):
                    while ei < len(evs) and evs[ei][0] <= ts:
                        while stack and stack[-1][1] < evs[ei][0]:
                            stack.pop()
                        stack.append(evs[ei])
                        ei += 1
                    while stack and stack[-1][1] < ts:
                        stack.pop()
                    self._enclosing[c] = tuple(e[2] for e in stack
                                               if e[1] >= ts)
        return self._enclosing.get(corr, ())

    def device_ms(self, span=None, kernel=None) -> tuple[float, int]:
        """(ms, count) of the device operations whose name satisfies
        ``kernel`` and whose launch lies inside a host event whose name
        satisfies ``span`` (each a predicate on a name, or None)."""
        ms, n = 0.0, 0
        for name, _, dur, corr in self.device:
            if kernel is not None and not kernel(name):
                continue
            if span is not None and not any(span(s)
                                            for s in self._spans_at(corr)):
                continue
            ms += dur / 1e3
            n += 1
        return ms, n

    def _busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) in microseconds."""
        lo, hi = self.window
        ivs = sorted((max(ts, lo), min(ts + dur, hi))
                     for _, ts, dur, _ in self.device)
        out = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            elif e > s:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        tot = collections.Counter()
        for name, _, dur, _ in self.device:
            tot[name] += dur / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds]]: the device's idle time inside the
        window, summed by the innermost host event open at each gap's start
        (on any thread; "host idle" when none is), largest first."""
        lo, hi = self.window
        busy = self._busy()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        best = [None] * len(gaps)
        for evs in self.host.values():
            # one sweep a thread: its events nest, so the open ones form a
            # stack whose top is the innermost
            stack, ei = [], 0
            for gi, (s, _) in enumerate(gaps):
                while ei < len(evs) and evs[ei][0] <= s:
                    while stack and stack[-1][1] <= evs[ei][0]:
                        stack.pop()
                    if evs[ei][2] != WINDOW:
                        stack.append(evs[ei])
                    ei += 1
                while stack and stack[-1][1] <= s:
                    stack.pop()
                if stack:
                    hs, he, name = stack[-1]
                    if best[gi] is None or he - hs < best[gi][0]:
                        best[gi] = (he - hs, name)
        tot = collections.Counter()
        for (s, e), b in zip(gaps, best):
            tot[b[1] if b else "host idle"] += (e - s) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]
