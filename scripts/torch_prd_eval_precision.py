"""How far the PRD evaluation's rounding reaches, on the CPU.

    python3 scripts/torch_prd_eval_precision.py [--seed N]

Builds ``chip_smoke.py``'s Truck-shaped NeRF++ scene (phase 18: 12 views of
546x980, 200 seeded points projected into every pair) and its experiment on
the CPU, draws the camera's noise leaves at 3e-3 from ``--seed`` (a trained
camera's size), and prints ``evaluate_nerfpp_prd``'s value with its
distances in float32 (the reference's, by casting ``prd_loss``'s inputs)
and in float64 (the port's), and for each the relative change when every
ray moves by one float32 ulp at random (four draws): the rounding by which
two devices' rays differ. Imports no JAX and needs no card.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from scnerf_tpu_torch.cli.train import parse_overrides  # noqa: E402
from scnerf_tpu_torch.core.config import load_experiment  # noqa: E402
from scnerf_tpu_torch.losses import prd_eval  # noqa: E402
from scnerf_tpu_torch.train import nerfpp_driver  # noqa: E402

DRAWS = 4


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory(prefix="prd_precision_") as root:
        K, poses = chip_smoke.write_truck_scene(os.path.join(root, chip_smoke.TRUCK_SCENE))
        expdir = os.path.join(root, "logs", chip_smoke.TRUCK_EXP)
        os.makedirs(expdir)
        chip_smoke.opencv_matches(K, poses, chip_smoke.TRUCK_MATCH_POINTS,
                                  chip_smoke.SEED + 18).save(os.path.join(expdir, "matches.npz"))
        argv = chip_smoke.truck_argv(root)
        cfg = load_experiment(argv[1], parse_overrides(argv[2:]))
        exp = nerfpp_driver.build_nerfpp_experiment(cfg, expdir, device="cpu")
        report(exp, args.seed)
        exp.logger.close()
    return 0


def report(exp, seed: int) -> None:
    camera = exp.state.params["camera"]
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in ("intrinsics_noise", "extrinsics_noise", "ray_o_grid", "ray_d_grid"):
            leaf = getattr(camera, name)
            leaf.copy_(torch.from_numpy(rng.normal(0.0, 3e-3, leaf.shape).astype(np.float32)))

    loss = prd_eval.prd_loss
    rays = nerfpp_driver.pixels_to_rays
    jitter = np.random.default_rng(seed + 1)

    def moved(*a, **kw):
        return tuple(torch.from_numpy(chip_smoke.one_ulp_moves(jitter, r.numpy()))
                     for r in rays(*a, **kw))

    def in_float32(*args, **kwargs):  # the reference's float32 distances
        def cast(x):
            if isinstance(x, tuple):
                return tuple(cast(v) for v in x)
            return x.float() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
        return loss(*cast(args), **{k: cast(v) for k, v in kwargs.items()})

    def prd(dtype, ray_fn=rays):
        prd_eval.prd_loss = in_float32 if dtype == torch.float32 else loss
        nerfpp_driver.pixels_to_rays = ray_fn
        try:
            return nerfpp_driver.evaluate_nerfpp_prd(exp)["prd"]
        finally:
            prd_eval.prd_loss = loss
            nerfpp_driver.pixels_to_rays = rays

    values = {dtype: prd(dtype) for dtype in (torch.float32, torch.float64)}
    for dtype, value in values.items():
        moves = [abs(prd(dtype, moved) / value - 1.0) for _ in range(DRAWS)]
        print(f"{str(dtype)[6:]} distances: PRD {value!r}; every ray one ulp at random, "
              f"relative change {', '.join(f'{m:.3g}' for m in moves)}")
    print(f"float32 against float64 distances: relative "
          f"{abs(values[torch.float32] / values[torch.float64] - 1.0):.3g}")


if __name__ == "__main__":
    sys.exit(main())
