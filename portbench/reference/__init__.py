"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch paths (each module names its source), with no kernel and nothing
imported from the port. ``correct`` is decided against it."""
