"""The port's recorder of host spans and counters.

    from articulation3d_tpu_torch import tracing

    with tracing.recording() as rec:
        preds = pipeline.run(frames)
    rec.summary()   # {"calls", "spans": {name: {"n", "wall_s", "self_s"}}, "counters"}

The program opens a span where its work happens (`with tracing.span(name):`)
and adds to a counter where it counts (`tracing.count(name, n)`).  Both do
nothing unless a recorder is on (`recording()`) or a `torch.profiler` is
running: on the plain path a count tests one flag and a span two (the
recorder's and the profiler's).

While recording, each span keeps its name, its parent span, the call it
belongs to (the innermost enclosing span opened with `call=True`, which
`VideoPipeline.run` is) and its start and end on `time.perf_counter_ns()`,
in a buffer of bounded size; `summary()` gives per name the count, the
total wall and the self time (the wall less the time its child spans
cover), and the counters.  Nothing is written to disk.

While a `torch.profiler` is active, each span is also a
`torch.profiler.record_function` range named "a3d.<name>", so the
program's spans sit in the device trace, on the profiler's clock, beside
the kernels they launched.

One recorder is on at a time.  Spans nest per thread; counters from any
thread (the autograd engine runs CUDA backward passes in its own) reach
it.  A host wait on the device is a `sync(site, where)` at the line that
waits: a "sync" span and one count of "sync.<site>" when `where` is on a
CUDA device (elsewhere nothing waits), so a call's host syncs are the sum
of the "sync.*" counters.

Apart from the recorder, `keeping()` collects what the program hands to
`keep(name, **tensors)`: references to tensors it made anyway (a training
step's proposals, anchor sample and sampled ROIs), with no copy and no
wait, so that a caller can read a step's discrete choices afterwards.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

PREFIX = "a3d."
CAPACITY = 1 << 16          # spans a recorder keeps (the oldest go first)


class Span(NamedTuple):
    """One closed span: `parent` and `call` are span ids (None: none)."""
    id: int
    name: str
    parent: Optional[int]
    call: Optional[int]
    start_ns: int
    end_ns: int


class Recorder:
    """The spans and counters of one `recording()` block."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=CAPACITY)
        self.counters: Dict[str, int] = {}
        self.calls = 0
        self._stats: Dict[str, List[int]] = {}      # name -> [n, wall ns, self ns]

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def _close(self, span: Span, self_ns: int, is_call: bool) -> None:
        self.spans.append(span)
        s = self._stats.setdefault(span.name, [0, 0, 0])
        s[0] += 1
        s[1] += span.end_ns - span.start_ns
        s[2] += self_ns
        self.calls += is_call

    def summary(self) -> dict:
        """{"calls": closed call spans, "spans": {name: {"n", "wall_s",
        "self_s"}}, "counters": {name: total}} over the whole block (not
        only the spans the buffer still holds)."""
        return {"calls": self.calls,
                "spans": {k: {"n": n, "wall_s": w * 1e-9, "self_s": s * 1e-9}
                          for k, (n, w, s) in self._stats.items()},
                "counters": dict(self.counters)}


_recorder: Optional[Recorder] = None       # the active one
_ids = itertools.count()
_local = threading.local()


class _Frame:
    __slots__ = ("id", "parent", "call", "child_ns", "recorder")

    def __init__(self, parent, is_call: bool):
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = self.id if is_call else (parent.call if parent is not None else None)
        self.child_ns = 0
        self.recorder = _recorder


class _Span:
    """An open span: `start_ns` and `end_ns` are its perf_counter_ns
    readings (set on entry and exit)."""

    __slots__ = ("name", "call", "start_ns", "end_ns", "_range", "_frame")

    def __init__(self, name: str, call: bool):
        self.name = name
        self.call = call

    def __enter__(self) -> "_Span":
        self._frame = None
        if _recorder is not None:
            stack = _stack()
            self._frame = _Frame(stack[-1] if stack else None, self.call)
            stack.append(self._frame)
        self.start_ns = time.perf_counter_ns()
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.end_ns = end = time.perf_counter_ns()
        f = self._frame
        if f is not None:
            stack = _stack()
            if stack and stack[-1] is f:
                stack.pop()
            elif f in stack:
                stack.remove(f)
            wall = end - self.start_ns
            if stack:
                stack[-1].child_ns += wall
            f.recorder._close(Span(f.id, self.name, f.parent, f.call, self.start_ns, end),
                              wall - f.child_ns, self.call)
        return False


class _Off:
    """The span of the plain path: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def span(name: str, *, call: bool = False, timed: bool = False):
    """A context manager that records the block as span `name`.  `call`:
    the span is a call that the spans inside it belong to.  `timed`: the
    returned object carries `start_ns`/`end_ns` even when nothing records
    (the pipeline's `chunk_walls` read them)."""
    if _recorder is not None or _profiler._is_profiler_enabled or timed:
        return _Span(name, call)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the active recorder."""
    r = _recorder
    if r is not None:
        r.counters[name] = r.counters.get(name, 0) + n


def _waits(where) -> bool:
    """Whether the host waits on `where` (a tensor, an array or a device):
    only a CUDA device makes it wait."""
    return getattr(where, "is_cuda", False) or getattr(where, "type", None) == "cuda"


def sync(site: str, where):
    """A span "sync" around one wait of the host for `where` (the tensor or
    device waited on), counted under "sync.<site>"; nothing where the host
    does not wait (`_waits`)."""
    if (_recorder is None and not _profiler._is_profiler_enabled) or not _waits(where):
        return _OFF
    count("sync." + site)
    return _Span("sync", False)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Turn a recorder on for the block and yield it.  One is on at a time:
    opening another inside the block raises."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recorder is already on")
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


_kept: Optional[Dict[str, dict]] = None     # the active `keeping()` block's


def keep(name: str, **tensors) -> None:
    """Hand `tensors` to the active `keeping()` block under `name` (the
    last call of a name wins); nothing when none is active."""
    k = _kept
    if k is not None:
        k[name] = tensors


@contextlib.contextmanager
def keeping() -> Iterator[Dict[str, dict]]:
    """Collect, for the block, what the program `keep`s: yields {name:
    {field: tensor}}.  One block at a time: opening another inside raises."""
    global _kept
    if _kept is not None:
        raise RuntimeError("a keeping() block is already open")
    out = _kept = {}
    try:
        yield out
    finally:
        _kept = None
