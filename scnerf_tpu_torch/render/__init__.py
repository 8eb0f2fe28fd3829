"""Compositing, the coarse-to-fine NeRF renderer and the NeRF++ cascade."""
