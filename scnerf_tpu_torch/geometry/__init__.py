"""NDC warp and the SO(3) helpers of the camera."""
