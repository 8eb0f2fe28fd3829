"""Positional encoding, the NeRF MLP and the NeRF++ fg/bg field."""
