"""The self-calibration experiments, each runnable with ``python -m``:

- ``scripts/_analytic_scene.py``: the analytic three-blob scene, rendered
  through the trainers' ray paths into the blender and NeRF++ layouts;
- ``scripts/soak_nerf.py``: the NeRF driver's quality soak on that scene
  (held-out PSNR gate, camera errors, the eval-protocol ladder);
- ``scripts/ablation_curriculum.py``: the curriculum ablation (five rows,
  from the GT poses to the full method) and the classical baselines;
- ``scripts/polish_calibration.py``: camera-only PRD polish and a field
  refit on a finished soak.

They run on the card unless given ``--device cpu``.
"""
