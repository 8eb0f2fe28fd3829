"""Compositing and the coarse-to-fine renderer."""
