"""Positional encoding and the NeRF MLP."""
