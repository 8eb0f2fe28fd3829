from scnerf_tpu_torch.camera.model import (
    CAMERA_LEAVES, FROZEN_LEAVES, OPENCV, OPENGL, TRAINABLE_LEAVES, Camera,
    CameraConfig, camera_leaves, get_distortion, get_extrinsic, get_extrinsics,
    get_intrinsic, init_camera, ray_d_noise_at, ray_o_noise_at,
    sample_noise_grid, trainable_camera,
)
from scnerf_tpu_torch.camera.rays import (
    apply_radial_distortion, full_image_pixels, pixels_to_rays,
    rays_full_image, rays_no_camera, rays_opencv,
)
