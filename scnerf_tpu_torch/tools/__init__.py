"""Host tools: COLMAP models, databases and runs, the classical calibration
baselines, the visualizers, video encoding and the reference-checkpoint
conversion (the exports of ``scnerf_tpu/tools/__init__.py``)."""
from scnerf_tpu_torch.tools.colmap import (
    read_cameras_bin, read_images_bin, read_points3d_bin, qvec2rotmat,
    colmap_to_c2w, sparse_to_poses_bounds, write_poses_bounds,
    normalize_cameras_to_unit_sphere,
)
from scnerf_tpu_torch.tools.calibration_baselines import (
    mendonca, classical_kruppa, simple_kruppa, daq, run_all_baselines,
    fundamental_from_matches,
)
from scnerf_tpu_torch.tools.convert import (
    torch_nerf_to_params, torch_mlpnet_to_params, torch_nerfnet_to_params,
    torch_camera_to_fields,
)
from scnerf_tpu_torch.tools.video import frames_to_video, array_to_video
