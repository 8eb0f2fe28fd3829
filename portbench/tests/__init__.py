"""CPU tests of the benchmark (``python -m pytest portbench/tests``); the
cases marked ``cuda`` run only where a card is present."""
