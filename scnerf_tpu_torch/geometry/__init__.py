"""NDC warp, the SO(3) helpers of the camera, and NeRF++'s unit sphere."""
from scnerf_tpu_torch.geometry.so3 import (
    ortho2rotation, rotation2orth, axis_angle_to_rotation,
    rotation_to_axis_angle, euler_to_rotation, rotation_to_euler,
    embed_rotation_44, se3_inverse, intrinsic_param_to_K, K_inverse_3x3,
)
from scnerf_tpu_torch.geometry.ndc import ndc_rays
from scnerf_tpu_torch.geometry.sphere import intersect_sphere, depth2pts_outside
from scnerf_tpu_torch.geometry.alignment import umeyama, align_c2w_trajectories, ate_rmse
