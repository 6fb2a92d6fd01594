"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer readers and the result's ``breakdown`` need.

Kept in memory; nothing is exported.  Device intervals are the kernels,
copies and sets the profiler recorded on the card (user annotations left
out); busy time is the length of their union inside the window, and the
idle gaps are what is left, each labelled by the innermost host operation
open on the benchmark's main thread at the gap's middle.  The categories are
``chip_smoke._device_breakdown``'s, copied.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: The benchmark's own range around the measured window.
WINDOW_RANGE = "bench.window"


def category(name: str) -> str:
    """``chip_smoke._category``: the kind of a device operation."""
    low = name.lower()
    if any(k in low for k in ("norm_affine_kernel", "filter_pair_kernel",
                              "conv3x3_")):
        return "port kernels"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                              "dgrad", "fprop", "sm90")):
        return "convolutions"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "copy" in low:
        return "layout copies"
    if "reduce" in low or "pool" in low:
        return "reductions and pools"
    return "other elementwise"


def _is_device(e) -> bool:
    return (getattr(e.device_type, "name", str(e.device_type)) == "CUDA"
            and not getattr(e, "is_user_annotation", False))


def device_us(e) -> float:
    """Device time attributed to a host event and its children, in us."""
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """The traced window: host events, device events, busy and idle."""

    def __init__(self, events, window_s: float):
        events = list(events)
        self.host = [e for e in events if not _is_device(e)
                     and getattr(e.device_type, "name",
                                 str(e.device_type)) == "CPU"]
        self.device = [e for e in events if _is_device(e)]
        win = [e for e in self.host if e.name == WINDOW_RANGE]
        if win:
            w = win[0].time_range
            self.start, self.end = float(w.start), float(w.end)
            self.main_thread = win[0].thread
        else:
            self.start = min((e.time_range.start for e in events), default=0)
            self.end = self.start + window_s * 1e6
            self.main_thread = None
        self.window_s = (self.end - self.start) / 1e6
        busy = union((max(float(e.time_range.start), self.start),
                      min(float(e.time_range.end), self.end))
                     for e in self.device
                     if e.time_range.end > self.start
                     and e.time_range.start < self.end)
        self.busy = [(s, e) for s, e in busy if e > s]
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.kernel_s = sum(e.time_range.end - e.time_range.start
                            for e in self.device) / 1e6

    def ops(self, name: str) -> List:
        """Host events of one operator or range, by name."""
        return [e for e in self.host if e.name == name]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def gap_labels(self, gaps: List[Tuple[float, float]]) -> List[str]:
        """The innermost main-thread host event open at each gap's
        middle, or 'no operator (Python or native host code)'."""
        evs = sorted((e for e in self.host
                      if (self.main_thread is None
                          or e.thread == self.main_thread)
                      and not getattr(e, "is_async", False)
                      and e.name != WINDOW_RANGE),
                     key=lambda e: (e.time_range.start, -e.time_range.end))
        out, stack, i = [], [], 0
        for s, e in sorted(gaps):
            mid = (s + e) / 2
            # Events of one thread nest: a stack swept in time order holds
            # the events open at `mid`, innermost on top.
            while i < len(evs) and evs[i].time_range.start <= mid:
                while stack and stack[-1].time_range.end < \
                        evs[i].time_range.start:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1].time_range.end < mid:
                stack.pop()
            out.append(stack[-1].name if stack
                       else "no operator (Python or native host code)")
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took the most time, by category and
        name, and the idle time by what the host was doing, in seconds."""
        by_kernel: Dict[str, float] = {}
        for e in self.device:
            key = f"{category(e.name)}: {e.name[:90]}"
            by_kernel[key] = by_kernel.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
        gaps = self.idle_gaps()
        by_host: Dict[str, float] = {}
        for (s, e), label in zip(gaps, self.gap_labels(gaps)):
            by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e6
        ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def op_shapes(e) -> Optional[List[List[int]]]:
    shapes = getattr(e, "input_shapes", None)
    return [list(s) for s in shapes] if shapes else None


def op_scalar(e, index: int) -> Optional[int]:
    """A recorded scalar argument of a host event, where the profiler kept
    it (``concrete_inputs``)."""
    vals = getattr(e, "concrete_inputs", None) or []
    if index < len(vals) and isinstance(vals[index], (int, float)) \
            and not isinstance(vals[index], bool):
        return int(vals[index])
    return None
