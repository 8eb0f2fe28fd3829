"""One module per kind of window a traffic mix names (``driver``): each has
``run(run) -> outcome``; see ``portbench/harness.py``."""
