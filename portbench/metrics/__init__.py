"""One reader per per-layer metric family, ``read(ctx, scope) -> value or
None`` (``<family>.py`` reads ``<family>.<scope>``), and the yardstick's
arithmetic: the peaks (``peaks.py``) and the counts of FLOPs and bytes
(``counts.py``)."""
