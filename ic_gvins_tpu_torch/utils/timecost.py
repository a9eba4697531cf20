"""The port's tracer: named host spans on one clock, nested, each tagged with
the frame being processed.

Off (the default) ``span`` returns one shared object that records nothing
and reads no clock. ``enable()`` clears the records and turns recording on:
each span then keeps ``(name, start_ns, end_ns, parent, frame)`` on
``time.perf_counter_ns``, where ``parent`` is the index of the enclosing
span's record (-1 at the top) and ``frame`` the index of the frame being
processed (set by the ``frame`` span, -1 before the first). While
``torch.profiler`` runs, each span also opens a profiler record function of
its name, which puts the program's stages on the profiler's timeline beside
the kernels they issue. It is the C++ ``_RecordFunctionFast``, not
``torch.profiler.record_function``: the latter goes through an operator call
at each end, and its stamps lie up to ~0.2 ms from the span's own on a long
span, where these lie within microseconds. Being a function record, not a
user annotation, it leaves no copy of itself on the device's rows of the
trace.

A :class:`Span` made directly always times itself, on or off: the three
sites whose times the port writes to statistics.txt (columns 10-12, the two
solve passes and the marginalization) and tracking.txt (column 7, the whole
frontend call).

Counters are plain integer attributes on the function that does the work:
``engine.host.fetch.reads`` (device -> host reads), ``solver.lm.solve.steps``
(LM iterations run) and the kernels' ``launches``.
"""

import functools
import time

import torch

# every span name the port uses, dotted by layer
NAMES = (
    "frame",
    "ins.propagate",
    "track.frame", "track.pyramid", "track.lk", "track.detect", "track.geometry",
    "nodes.add", "gnss.drain",
    "ep.optimize", "ep.tables", "lm.pass1", "lm.surgery", "lm.pass2", "ep.update", "ep.cull", "ep.remove",
    "marg", "marg.tables", "marg.schur",
    "host.fetch",
    "stats.write",
)

_on = False
_frame = -1
_records = []     # (name, start_ns, end_ns, parent, frame); end_ns None while open
_open = []        # indices of the open records, innermost last


class Span:
    """A timed stretch of host time. Made by :func:`span` while the tracer is
    on, it is also recorded (and mirrored into a running profiler); made
    directly it always times itself. ``ns``, ``ms`` and ``seconds`` hold its
    duration once it has closed."""

    __slots__ = ("name", "frame", "start_ns", "end_ns", "_index", "_records", "_open", "_mirror")

    def __init__(self, name, frame=None):
        self.name, self.frame = name, frame
        self.start_ns = self.end_ns = 0
        self._index = self._mirror = None

    def __enter__(self):
        global _frame
        if _on:
            if self.frame is not None:
                _frame = self.frame
            # a span that outlives an enable() closes into the records it opened in
            self._records, self._open, self._index = _records, _open, len(_records)
            _records.append((self.name, 0, None, _open[-1] if _open else -1, _frame))
            _open.append(self._index)
            if torch.autograd._profiler_enabled():
                self._mirror = torch._C._profiler._RecordFunctionFast(self.name)
                self._mirror.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._index is not None:
            if self._mirror is not None:
                self._mirror.__exit__(*exc)
            self._open.pop()
            name, _, _, parent, frame = self._records[self._index]
            self._records[self._index] = (name, self.start_ns, self.end_ns, parent, frame)
        return False

    @property
    def ns(self):
        return self.end_ns - self.start_ns

    @property
    def ms(self):
        return self.ns / 1e6

    @property
    def seconds(self):
        return self.ns / 1e9


class _Off:
    """What :func:`span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, frame=None):
    """A context manager around one stage; ``frame`` (the ``frame`` span's)
    sets the index the spans inside it carry."""
    return Span(name, frame) if _on else _OFF


def traced(name):
    """Decorator: the whole call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enable():
    """Clear the records and record every span from now on."""
    global _on, _frame, _records, _open
    _on, _frame, _records, _open = True, -1, [], []


def disable():
    """Stop recording; the records stay until the next :func:`enable`."""
    global _on
    _on = False


def enabled():
    return _on


def records():
    """The records so far, in the order their spans opened."""
    return list(_records)


def self_ns(recs):
    """Each record's duration less its direct children's: the time the span
    spent outside every span inside it (None while it is open)."""
    out = [None if e is None else e - s for _, s, e, _, _ in recs]
    for _, s, e, parent, _ in recs:
        if parent >= 0 and e is not None and out[parent] is not None:
            out[parent] -= e - s
    return out
