"""Whole-framework examples of self-calibration, each runnable with
``python -m scnerf_tpu_torch.examples.<name>`` and callable as
``main(steps=None, device="cuda")``, which returns the outcomes as a dict:

- ``calibration_ablation``: noisy cameras, trained with and without the
  learnable camera, held-out PSNR of each;
- ``self_calibration_demo``: noisy cameras recovered by photometric + PRD
  training;
- ``from_scratch_calibration``: identity rotations, zero translations and
  a wrong focal recovered on a forward-facing rig;
- ``distortion_discovery``: radial distortion found from k = 0 by the
  distortion-aware PRD alone.
"""
