"""The program's own spans and counters, as the readers of
``draw_host_ms``, ``prd_host_ms``, ``serve_upload_ms`` and
``serve_pad_share`` take them.

The program (``scnerf_tpu_torch/train/profiling.py``) keeps a span, with its
``perf_counter_ns`` readings and the number of its step or request, and adds
to its counters only while a ``torch.profiler`` session records: here, in
the traced segment, which runs its steps or frames once for each of its two
profiler passes. The readers take the first pass, which records the device
alone and slows the host least. A program without the recorder reads
``None``.
"""
from __future__ import annotations

import statistics


def recorder(ctx: dict):
    """What holds the program's spans and counters (``spans()``,
    ``counters()``): ``ctx["recorder"]`` where given, else the program's
    profiling module; ``None`` where the program keeps none."""
    if "recorder" in ctx:
        return ctx["recorder"]
    from scnerf_tpu_torch.train import profiling

    return profiling if hasattr(profiling, "spans") else None


def units(ctx: dict, root: str) -> dict[int, list] | None:
    """The spans of each step or request of the traced segment's first
    pass, by its number: the first ``trace["units"]`` numbers of the
    ``root`` spans. ``None`` without a recorder, a trace or a ``root``
    span."""
    rec, trace = recorder(ctx), ctx.get("trace")
    if rec is None or not trace:
        return None
    records = rec.spans()
    ids = sorted({r.id for r in records if r.name == root and r.id is not None})
    first = set(ids[:trace["units"]])
    if not first:
        return None
    out: dict[int, list] = {i: [] for i in first}
    for r in records:
        if r.id in first:
            out[r.id].append(r)
    return out


def median_ms(ctx: dict, root: str, names: tuple[str, ...]) -> float | None:
    """The median, over the first pass's steps or requests that hold a span
    of ``names``, of the milliseconds in those spans."""
    by_unit = units(ctx, root)
    if by_unit is None:
        return None
    ms = [sum(r.end_ns - r.start_ns for r in rs if r.name in names) * 1e-6
          for rs in by_unit.values() if any(r.name in names for r in rs)]
    return statistics.median(ms) if ms else None
