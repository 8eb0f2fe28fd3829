"""Host tools: video encoding and the reference-checkpoint conversion."""
