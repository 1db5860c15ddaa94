"""The profiler's reading: the device's operations in the traced window,
their union (busy time), the gaps between them and what the host was
doing in each, and the device operations launched inside the harness's
own `record_function` ranges (linked by the profiler's correlation ids:
a kernel to the innermost host op that launched it, that op to the range
around it on its thread)."""

from __future__ import annotations

import bisect
import collections

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "bench.window"


def short(name: str, n: int = 100) -> str:
    """A kernel's name without its return type and argument list, at most
    n characters."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    if not base.startswith("Memcpy"):
        base = base.split("(", 1)[0]
    return base[:n]


def start_profiler(device, host: bool = True):
    """A torch.profiler session over the host and, on a card, the device;
    with `host` false, over the card's activity alone (the host's ops are
    not recorded, which spares the host the profiler's cost for each)."""
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not card else []) + (
        [ProfilerActivity.CUDA] if card else [])
    p = profile(activities=acts)
    p.start()
    return p


class Trace:
    """ops: (start_s, end_s, name, linked_correlation) device operations;
    cpu: (start_s, end_s, name, thread, correlation, activity) host events;
    window: (start_s, end_s), the span of the harness's window range; where
    the trace holds none (a trace of the card alone), `wall`, the traced
    stretch's start and stop by time.time_ns() (the profiler's clock),
    where the operations lie inside it, else the operations' own span."""

    def __init__(self, ops, cpu, window=None, wall=None):
        self.cpu = sorted(cpu)
        if window is None:
            w = [e for e in self.cpu if e[2] == WINDOW_RANGE]
            span = (min(o[0] for o in ops), max(o[1] for o in ops)) if ops else (0.0, 0.0)
            if w:
                window, self.window_from = (w[0][0], w[-1][1]), "range"
            elif wall is not None and wall[0] - 1.0 <= span[0] and span[1] <= wall[1] + 1.0:
                window, self.window_from = wall, "wall"
            else:
                window, self.window_from = span, "ops"
        else:
            self.window_from = "given"
        self.window = window
        w0, w1 = window
        self.ops = sorted((max(s, w0), min(e, w1), n, c) for s, e, n, c in ops if e > w0 and s < w1)

    @classmethod
    def from_profiler(cls, prof, wall=None):
        from torch.autograd import DeviceType

        ops, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            act = _activity(e)
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CUDA:
                if act in DEVICE_ACTIVITIES:
                    ops.append((start, end, e.name(), e.linked_correlation_id()))
            elif e.device_type() == DeviceType.CPU:
                cpu.append((start, end, e.name(), e.start_thread_id(), e.correlation_id(), act))
        return cls(ops, cpu, wall=wall)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        """The union of the device operations' intervals, in order."""
        out = []
        for s, e, _, _ in self.ops:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self):
        """(start, end) of each idle stretch of the window."""
        out, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def select(self, pred):
        """(total seconds, count) of the operations whose name passes pred."""
        hits = [e - s for s, e, n, _ in self.ops if pred(n)]
        return sum(hits), len(hits)

    def in_range(self, range_name: str):
        """The device operations launched inside host ranges named
        range_name: [(start, end, name)]."""
        by_corr = {c[4]: c for c in self.cpu}
        ranges = collections.defaultdict(list)
        for c in self.cpu:
            if c[2] == range_name:
                ranges[c[3]].append((c[0], c[1]))
        starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
        out = []
        for s, e, n, link in self.ops:
            src = by_corr.get(link)
            if src is None or src[3] not in ranges:
                continue
            rs = ranges[src[3]]
            i = bisect.bisect_right(starts[src[3]], src[0]) - 1
            if i >= 0 and rs[i][1] >= src[0]:
                out.append((s, e, n))
        return out

    def launch_thread(self):
        """The host thread that launched most device operations."""
        by_corr = {c[4]: c[3] for c in self.cpu if c[5] != "user_annotation"}
        counts = collections.Counter(by_corr.get(link) for *_, link in self.ops)
        counts.pop(None, None)
        return counts.most_common(1)[0][0] if counts else None

    def breakdown(self, n: int = 10):
        """{"device_ops": the n operations with the most device time,
        "idle_gaps": idle time summed by what the host was doing, the n
        largest}: [[name, seconds], ...]."""
        per_op = collections.Counter()
        for s, e, name, _ in self.ops:
            per_op[short(name)] += e - s
        tid = self.launch_thread()
        label = _Labeler([c for c in self.cpu if c[3] == tid] if tid is not None else [])
        idle = collections.Counter()
        for s, e in self.gaps():
            idle[label(0.5 * (s + e))] += e - s
        return {"device_ops": [[k, v] for k, v in per_op.most_common(n)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(n)]}


def _activity(e):
    """The event's kind ("kernel", "gpu_memcpy", "user_annotation", ...),
    or a guess from older profilers that do not name it."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return "user_annotation"
    return "kernel"


class _Labeler:
    """What one host thread was doing at a time: the innermost harness
    range and the innermost host op around it."""

    def __init__(self, evs):
        self.ranges = [e for e in evs if e[2].startswith("bench.") and e[2] != WINDOW_RANGE]
        self.ops = [e for e in evs if not e[2].startswith("bench.")]
        self.range_starts = [e[0] for e in self.ranges]
        self.op_starts = [e[0] for e in self.ops]

    @staticmethod
    def _innermost(evs, starts, t, scan):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - scan), -1):
            if evs[j][1] >= t:
                return evs[j]
        return None

    def __call__(self, t):
        rng = self._innermost(self.ranges, self.range_starts, t, len(self.ranges))
        op = self._innermost(self.ops, self.op_starts, t, 4000)
        return " > ".join([rng[2] if rng else "outside the harness's ranges",
                           short(op[2], 60) if op else "python between ops"])
