"""Photometric losses and the projected ray distance (PRD) loss."""
