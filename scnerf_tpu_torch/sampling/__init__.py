"""Stratified depths, sorted search and the inverse-CDF resampler."""
