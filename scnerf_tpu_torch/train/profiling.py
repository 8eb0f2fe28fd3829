"""Step timing, tracing, profiling and numerics debugging.

Port of ``scnerf_tpu/train/profiling.py`` onto ``torch.profiler`` and
autograd's anomaly mode:

- :func:`span` and :func:`count`: the program's own spans and counters,
  recorded only while a ``torch.profiler`` session records (:class:`Recorder`);
  each span is also a ``record_function`` range on the profiler's clock, so
  the trace names the host's time, and the kernels launched in it, by the
  program's layer. :func:`spans` and :func:`counters` return what was kept.
- :class:`StepTimer`: the host's time per loop iteration, with a warm-up
  skip and a percentile summary; it opens the iteration's span.
- :func:`trace`: ``torch.profiler`` over the CPU and the card, writing a
  Chrome trace (``*.pt.trace.json``) that TensorBoard and Perfetto open.
- :func:`debug_nans`: scoped anomaly detection, and a check of every
  operator's floating output for NaN (the forward half of JAX's
  ``jax_debug_nans``, which anomaly mode lacks).
- :func:`check_finite_tree`: the names of the non-finite leaves of a tree.
- :func:`profile_rows` / :func:`roofline_summary` / :func:`measure_roofline`:
  the per-step device time and FLOPs of a profiled run, read from
  ``key_averages()``; in place of the JAX package's xprof ``hlo_stats``
  parser. ``torch.profiler`` gives no per-operator memory traffic or
  bound-by verdict, so ``measured_hbm_bytes_per_step`` and ``bound_by_pct``
  have no counterpart.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


SPAN_CAPACITY = 65536
STEP_SPAN = "scnerf.loop.step"
_profiler_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One finished span: its name, the name of the span open around it on
    the same thread (``None`` at the top), the step or request number that
    the spans of one step or request share, and its ``perf_counter_ns``
    readings."""

    name: str
    parent: str | None
    id: int | None
    start_ns: int
    end_ns: int


class _NullSpan:
    """The span of a process that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def open(self, start_ns: int) -> None:
        pass

    def close(self, end_ns: int) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("recorder", "name", "id", "parent", "start_ns", "range")

    def __init__(self, recorder: "Recorder", name: str, id: int | None):
        self.recorder, self.name, self.id = recorder, name, id

    def __enter__(self):
        self.open(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self.close(time.perf_counter_ns())
        return False

    def open(self, start_ns: int) -> None:
        stack = self.recorder._stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        stack.append(self)
        self.start_ns = start_ns
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()

    def close(self, end_ns: int) -> None:
        self.range.__exit__(None, None, None)
        self.recorder._stack().pop()
        self.recorder._records.append(
            SpanRecord(self.name, self.parent, self.id, self.start_ns, end_ns))


class Recorder:
    """Spans and counters, kept while a ``torch.profiler`` session records
    and at no other time.

    A span (:meth:`span`) opens a ``record_function`` range of its name,
    which the profiler's trace shows as a ``user_annotation`` over the
    host's operators, and keeps a :class:`SpanRecord` in a ring of the last
    ``capacity``. A span without an ``id`` takes the one of the span open
    around it on the same thread. Counters (:meth:`count`) are integer
    totals. With no session recording, :meth:`span` returns a shared no-op
    context and :meth:`count` returns: one check of the profiler's state
    each."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._records: collections.deque[SpanRecord] = collections.deque(maxlen=capacity)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, id: int | None = None):
        """A context that records the block as the span ``name``
        (``scnerf.<layer>.<what>``) of step or request ``id``."""
        if not _profiler_enabled():
            return _NULL_SPAN
        return _Span(self, name, id)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        if _profiler_enabled():
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def spans(self) -> list[SpanRecord]:
        """The kept spans, in the order they ended."""
        return list(self._records)

    def counters(self) -> dict[str, int]:
        """The counters' totals."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        """Drop the kept spans and the counters."""
        self._records.clear()
        with self._lock:
            self._counts.clear()


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters


class StepTimer:
    """The host's milliseconds a loop iteration, with a warm-up skip and a
    percentile summary. ``with timer(step):`` times one iteration and opens
    its :data:`STEP_SPAN` span on the same ``perf_counter_ns`` readings.

    It reads the host's pace: a step returns before the card has run it, so
    an iteration's time is the host's draw, copy and launches, and it is
    the card's pace only while the launch queue is full and the host waits
    at a launch. Kept across calls of a loop, so that a loop called one
    step at a time gets past its warm-up."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times_ns: list[int] = []
        self._count = 0
        self._t0 = 0
        self._span = _NULL_SPAN

    def __call__(self, step: int) -> "StepTimer":
        self._span = span(STEP_SPAN, step)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._span.open(self._t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._span.close(t1)
        self._span = _NULL_SPAN
        self._count += 1
        if self._count > self.warmup:
            self._times_ns.append(t1 - self._t0)
        return False

    def summary(self) -> dict:
        if not self._times_ns:
            return {"steps": 0}
        arr = np.asarray(self._times_ns, np.float64) * 1e-6
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
        }


@contextlib.contextmanager
def trace(logdir: str | None, *, activities=None, with_flops: bool = True):
    """Profile the block with ``torch.profiler`` over the CPU and, when
    there is one, the card; yields the profiler. With a ``logdir``, the
    trace is written there when the block ends (a ``*.pt.trace.json`` for
    TensorBoard's profiler plugin or Perfetto). The card's queue is waited
    for before the profiler stops, so the block's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    handler = None
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        handler = tensorboard_trace_handler(logdir)
    with profile(activities=activities, with_flops=with_flops, on_trace_ready=handler) as prof:
        try:
            yield prof
        finally:
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()


class _RaiseOnNaN(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(x, torch.Tensor) and x.is_floating_point() and x.device.type != "meta"
                    and bool(torch.isnan(x).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise where a NaN appears inside the block, as JAX's scoped
    ``jax_debug_nans``: ``FloatingPointError`` from the first operator whose
    floating output holds a NaN (each output is read back, so the card waits
    at every operator), and autograd's anomaly mode, under which a NaN in
    the backward raises too and names the forward operator that made it
    (``RuntimeError`` where the backward's operators run outside this
    thread's check). The caller's anomaly setting is restored after.
    ``enable=False`` turns both off for the block."""
    prev = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        with _RaiseOnNaN() if enable else contextlib.nullcontext():
            yield
    finally:
        torch.autograd.set_detect_anomaly(prev, prev_check)


def check_finite_tree(tree, prefix: str = "") -> list[str]:
    """Names of the floating leaves holding NaN or Inf (empty: clean). A
    leaf's name is its path of dict keys, list indices and dataclass fields
    joined by ``.``, after ``prefix``, as JAX's for the same tree."""
    bad = []

    def visit(path, leaf):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                visit(path + [str(k)], v)
        elif isinstance(leaf, (list, tuple)):
            for i, v in enumerate(leaf):
                visit(path + [str(i)], v)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            for f in dataclasses.fields(leaf):
                visit(path + [f.name], getattr(leaf, f.name))
        else:
            if isinstance(leaf, torch.Tensor):
                arr = leaf.detach().cpu().numpy() if leaf.is_floating_point() else None
            else:
                try:
                    arr = np.asarray(leaf)
                except Exception:
                    return
            if arr is not None and arr.dtype.kind == "f" and not np.isfinite(arr).all():
                bad.append(prefix + ".".join(path))

    visit([], tree)
    return bad


PROFILE_COLUMNS = ("name", "device", "calls", "self_device_us", "device_us", "self_cpu_us",
                   "flops")


def profile_rows(prof):
    """The operators and kernels of a finished ``torch.profiler`` run:
    ``(cols, rows)``, ``cols`` being :data:`PROFILE_COLUMNS` and each row
    one entry of ``key_averages()``. ``device`` is ``"cuda"`` for a kernel
    (or copy, or memset) on the card and ``"cpu"`` for an operator, a
    runtime call or a profiler range on the host; a range, which the card's
    timeline also shows over its kernels, is kept as a ``"cpu"`` row only,
    so that no kernel is counted twice. ``device_us`` is a kernel's own time
    or, for a host row, the time of the kernels launched inside it.
    ``flops`` are the profiler's estimates (``with_flops``) for the
    operators that have a formula (matrix products, convolutions,
    elementwise add and multiply)."""
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    rows = []
    for e in events:
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if on_card and (e.key in host_names or getattr(e, "is_user_annotation", False)):
            continue
        rows.append([e.key, "cuda" if on_card else "cpu", e.count,
                     e.self_device_time_total if on_card else 0.0, e.device_time_total,
                     0.0 if on_card else e.self_cpu_time_total,
                     0 if on_card else (e.flops or 0)])
    return list(PROFILE_COLUMNS), rows


def roofline_summary(cols, rows, n_steps: int) -> dict:
    """Per-step numbers of a :func:`profile_rows` table over ``n_steps``
    steps: ``device_us_per_step``, the kernels' self time on the card (the
    operators' self time on the CPU when no kernel ran), and
    ``measured_flops_per_step``, the operators' estimated FLOPs. ``{}`` for
    an empty table."""
    if not rows:
        return {}
    col = {c: i for i, c in enumerate(cols)}
    kernels = [r for r in rows if r[col["device"]] == "cuda"]
    if kernels:
        us = sum(r[col["self_device_us"]] for r in kernels)
    else:
        us = sum(r[col["self_cpu_us"]] for r in rows)
    flops = sum(r[col["flops"]] for r in rows)
    return {"device_us_per_step": us / n_steps, "measured_flops_per_step": flops / n_steps}


def measure_roofline(run_steps, n_steps: int = 10, logdir: str | None = None) -> dict:
    """Profile ``run_steps(n_steps)`` (a trace written to ``logdir`` when
    given) and return :func:`roofline_summary`'s numbers; ``{}`` when the
    profiler yields nothing."""
    with trace(logdir) as prof:
        run_steps(n_steps)
    cols, rows = profile_rows(prof)
    return roofline_summary(cols, rows, n_steps)
