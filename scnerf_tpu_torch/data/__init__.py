"""Datasets (LLFF), camera-noise injection and host-side batching."""
