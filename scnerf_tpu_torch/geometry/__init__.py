"""NDC warp, the SO(3) helpers of the camera, and NeRF++'s unit sphere."""
