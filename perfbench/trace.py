"""The traced run: a short steady span of whole steps under
``torch.profiler`` (CPU and CUDA activities), reduced to plain
numbers.

**Work items.** On a card, every device activity (kernels, copies,
sets) the trace holds, user annotations left out. In a profile with no
device activity (the CPU), each ``aten::`` op's own host time stands in
for one: that is how the attribution is tested without a card, never
how a device number is made.

**Attribution to a layer.** A work item belongs to the op that launched
it (the kernels the profiler lists under each CPU op; the profiler's own
bookkeeping events are left out). A layer is entered through functions
of the program (``module:function``); for the traced steps alone the
harness wraps each in a ``record_function`` range of its own
(:func:`layer_ranges`: nothing inside the program changes, and the
untimed wrapper costs the host a few microseconds a call). An op is the
layer's in the forward where it runs inside that range; an op of the
backward is where the autograd node it evaluates carries the sequence
number of such a forward op (on that op's thread). A layer's device
time is the sum of the durations of the work items of its ops. A range
of torch's own (``Optimizer.step#...``) is read by prefix.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
from typing import Dict, List, Sequence, Tuple

import torch

SPAN = "perfbench.span"
LAYER = "perfbench.layer."
#: The profiler's own events, which it lists with kernels of other ops.
BOOKKEEPING = ("Activity Buffer Request", "Command Buffer Full")
EVALUATE = "autograd::engine::evaluate_function:"
_DEVICE_TYPES = ("CUDA",)


def _is_device(e) -> bool:
    return e.device_type.name in _DEVICE_TYPES


def busy_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``[start, end)`` intervals (seconds)."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """A profile's events, indexed for attribution. Times in seconds on
    the trace's own clock."""

    def __init__(self, events):
        events = list(events)
        self.cpu = [e for e in events if e.device_type.name == "CPU"]
        annotations = {e.name for e in self.cpu
                       if getattr(e, "is_user_annotation", False)
                       or e.name == SPAN or e.name.startswith("Optimizer.")}
        device = [e for e in events if _is_device(e)
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in annotations]
        self.on_device = bool(device)
        self.device = [(k.name, k.time_range.start / 1e6,
                        k.time_range.end / 1e6) for k in device]
        # (owner op, seconds) of every work item.
        self.items: List[Tuple[object, float]] = []
        for e in self.cpu:
            if e.name in BOOKKEEPING:
                continue
            if device:
                self.items += [(e, k.duration / 1e6) for k in e.kernels
                               if k.name not in annotations]
            elif e.name.startswith("aten::") and e.self_cpu_time_total > 0:
                self.items.append((e, e.self_cpu_time_total / 1e6))
        spans = [e for e in self.cpu if e.name == SPAN]
        self.span = spans[0] if spans else None

    def _under(self, pred) -> set:
        """ids of the ops that are, or lie under, an op ``pred`` holds."""
        memo: Dict[int, bool] = {}

        def hit(e) -> bool:
            k = id(e)
            if k not in memo:
                p = e.cpu_parent
                memo[k] = bool(pred(e)) or (p is not None and hit(p))
            return memo[k]

        return {id(e) for e in self.cpu if hit(e)}

    def _seconds(self, ops: set) -> float:
        return sum(t for owner, t in self.items if id(owner) in ops)

    def layer_seconds(self, key: str) -> float:
        """Device seconds of layer ``key``: the ops inside its ranges
        (:func:`layer_ranges`) and the backward of those ops."""
        name = LAYER + key
        forward = self._under(lambda e: e.name == name)
        seqs = {(e.thread, e.sequence_nr) for e in self.cpu
                if id(e) in forward and e.sequence_nr >= 0}

        def backward_of(e):
            return (e.name.startswith(EVALUATE)
                    and (e.fwd_thread, e.sequence_nr) in seqs)

        return self._seconds(forward | self._under(backward_of))

    def range_seconds(self, prefix: str) -> float:
        """Device seconds under ranges whose name starts with ``prefix``."""
        return self._seconds(self._under(lambda e: e.name.startswith(prefix)))

    def span_seconds(self) -> Tuple[float, float]:
        """(start, end) of the traced span."""
        return (self.span.time_range.start / 1e6,
                self.span.time_range.end / 1e6)

    def _intervals(self):
        """The work items' intervals inside the span: the device
        activities on a card (the CPU stand-ins have none)."""
        s0, s1 = self.span_seconds()
        return [(max(a, s0), min(b, s1)) for _, a, b in self.device
                if b > s0 and a < s1]

    def busy(self) -> float:
        return busy_seconds(self._intervals())

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest
        idle stretches grouped by what the host was doing (the innermost
        op of the span's thread around the stretch's middle)."""
        by_name: Dict[str, float] = {}
        for name, t0, t1 in self.device:
            by_name[name[:96]] = by_name.get(name[:96], 0.0) + (t1 - t0)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        s0, s1 = self.span_seconds()
        busy = merge(self._intervals())
        edges = [s0] + [x for iv in busy for x in iv] + [s1]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:200]
        thread = self.span.thread
        host = [e for e in self.cpu if e.thread == thread and e is not self.span]
        by_host: Dict[str, float] = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2 * 1e6
            inner = None
            for e in host:
                r = e.time_range
                if r.start <= mid < r.end and (
                        inner is None or r.end - r.start
                        < inner.time_range.end - inner.time_range.start):
                    inner = e
            name = "(no op)" if inner is None else inner.name[:96]
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


@contextlib.contextmanager
def layer_ranges(calls: Dict[str, Sequence[str]]):
    """While the block runs, each ``module:function`` of ``calls[key]``
    runs inside a ``record_function`` range named ``perfbench.layer.<key>``:
    every attribute of the program's loaded modules that holds the
    function is swapped for the wrapper, and restored after."""
    from torch.profiler import record_function
    swaps = []
    for key, targets in calls.items():
        for target in targets:
            mod_name, fn_name = target.split(":")
            orig = getattr(importlib.import_module(mod_name), fn_name)

            @functools.wraps(orig)
            def wrapped(*args, _orig=orig, _name=LAYER + key, **kw):
                with record_function(_name):
                    return _orig(*args, **kw)

            package = mod_name.split(".")[0]
            for name, mod in list(sys.modules.items()):
                if (name.split(".")[0] == package
                        and getattr(mod, fn_name, None) is orig):
                    swaps.append((mod, fn_name, orig))
                    setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, orig in reversed(swaps):
            setattr(mod, fn_name, orig)


def profile_steps(run_step, steps: int, sync, device: torch.device,
                  calls: Dict[str, Sequence[str]]):
    """Run ``steps`` whole steps under the profiler, inside one
    :data:`SPAN` range that starts and ends with the device idle, the
    layers' entry functions ``calls`` in ranges of their own; returns
    the :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with layer_ranges(calls), profile(activities=acts) as prof:
        with record_function(SPAN):
            for _ in range(steps):
                run_step()
            sync()
    return Trace(prof.events())


def summarize(trace: Trace, requests: Dict[str, Tuple[str, object]],
              steps: int) -> Dict[str, object]:
    """Plain numbers of a trace: ``span_s`` and ``busy_s`` of the
    traced span, the seconds of every device activity (``device_s``) and
    of those the profiler linked to an op (``linked_s``), the device
    seconds a step of each request (``("calls", functions)``: a layer;
    ``("range", prefix)``: a range of torch's), and the breakdown."""
    s0, s1 = trace.span_seconds()
    out = {"on_device": trace.on_device, "steps": steps,
           "span_s": s1 - s0, "busy_s": trace.busy(),
           "device_s": sum(b - a for _, a, b in trace.device),
           "linked_s": sum(t for _, t in trace.items), "layers": {}}
    for key, (kind, what) in requests.items():
        secs = (trace.layer_seconds(key) if kind == "calls"
                else trace.range_seconds(what))
        out["layers"][key] = secs / steps
    out["breakdown"] = trace.breakdown()
    return out

