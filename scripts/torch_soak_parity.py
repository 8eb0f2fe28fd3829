"""The NeRF quality soak in the JAX package and in the port.

    JAX_PLATFORMS=cpu python3 scripts/torch_soak_parity.py lockstep \
        [--steps 300] [--every 10] [--camera_lr_mult 8] [--out LOCKSTEP.json]
    JAX_PLATFORMS=cpu python3 scripts/torch_soak_parity.py sweep \
        [--seeds 777 1 2 3 4] [--steps 1000] [--camera_lr_mult 8] [--out SWEEP.json]
    python3 scripts/torch_soak_parity.py sweep --packages port --device cuda --full \
        [--seeds 777 1 2 3] [--steps 2500] [--out SWEEP.json]

Both modes run the soak of ``scripts/soak_nerf.py`` and
``scnerf_tpu_torch/scripts/soak_nerf.py``, at ``--small`` (12 train views of
40x56, NeRF 2x32, N_rand 128, 8+8 samples) unless ``--full`` is given, with
the camera's learning rate times ``--camera_lr_mult`` until
``--camera_lr_until`` (the JAX record's protocol is x8 until step 5,000).
The JAX package runs on the CPU; the port on ``--device``.

- ``lockstep`` (the CPU, both packages): one experiment of each package
  built from the same flags; the port starts from the JAX experiment's
  parameters, and every step both take the same batch (the JAX driver's
  host draw, its PRD pair on the PRD steps) and the same random numbers
  (jitter, sigma noise, fine-sample u). A control runs beside them: the JAX
  step from the same parameters moved one float32 ulp (each entry, a random
  direction), on the same batches. Every ``--every`` steps it prints the
  losses and, for each camera leaf, the L2 gap between the port and JAX and
  between the control and JAX, beside the leaf's move from its start, and
  each camera's decoded focal and Sim(3)-aligned errors (``camera_errors``
  of the port on both cameras). So it shows whether the two steps move the
  camera alike, leaf by leaf, on the same draws, against how far rounding
  alone parts them.
- ``sweep``: each named package's own soak ``main`` for each ``--seeds``
  value (the config's ``seed``: it draws the camera noise, the MLPs and the
  step streams), with the held-out PSNR and the camera errors along the run
  and at its end. So it shows how the outcome spreads over realizations.
  With ``--packages port`` it imports no JAX and runs on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import (  # noqa: E402
    TRAINABLE_LEAVES,
    get_intrinsic,
    host_camera,
)
from scnerf_tpu_torch.core.config import experiment_from_flags  # noqa: E402
from scnerf_tpu_torch.data.blender import load_blender  # noqa: E402
from scnerf_tpu_torch.scripts import soak_nerf as t_soak  # noqa: E402
from scnerf_tpu_torch.scripts._analytic_scene import build_blender_scene  # noqa: E402
from scnerf_tpu_torch.train import driver as t_driver  # noqa: E402
from scnerf_tpu_torch.train.curriculum import prd_cadence_at  # noqa: E402
from scnerf_tpu_torch.train.step import create_train_state  # noqa: E402

H, W = 40, 56
ERR_KEYS = ("rot_err_deg", "trans_err", "focal_rel_err")


def protocol(args) -> dict:
    return dict(camera_lr_mult=args.camera_lr_mult, camera_lr_until=args.camera_lr_until,
                add_prd=args.add_prd)


def _to_port(x):
    v = np.asarray(x)
    return torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v.copy())


def _one_ulp(x: np.ndarray, rng) -> np.ndarray:
    """``x`` with each float32 entry moved one ulp up or down at random."""
    if x.dtype != np.float32:
        return x
    up = rng.random(x.shape) < 0.5
    return np.where(up, np.nextafter(x, np.float32(np.inf)),
                    np.nextafter(x, np.float32(-np.inf))).astype(np.float32)


def _jax():
    """The JAX package's modules this script uses, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scnerf_tpu.core.config as config
    import soak_nerf  # scripts/soak_nerf.py
    from scnerf_tpu.camera.model import get_intrinsic
    from scnerf_tpu.train import driver

    return types.SimpleNamespace(jax=jax, config=config, soak=soak_nerf, driver=driver,
                                 get_intrinsic=get_intrinsic)


def _jax_camera_errors(j_exp) -> dict:
    """The port's ``camera_errors`` on the JAX experiment's camera."""
    import jax

    cam = bridge.camera_from_numpy(jax.tree.map(np.asarray, j_exp.state.params["camera"]),
                                   device="cpu")
    view = types.SimpleNamespace(state=types.SimpleNamespace(params={"camera": cam}),
                                 gt_poses=j_exp.gt_poses, i_train=j_exp.i_train,
                                 gt_intrinsic=j_exp.gt_intrinsic)
    return t_soak.camera_errors(view)


def lockstep(args) -> dict:
    J = _jax()
    jax, j_driver = J.jax, J.driver
    root = tempfile.mkdtemp(prefix="soak_lockstep_")
    scene = os.path.join(root, "scene")
    build_blender_scene(scene, n_train=12, n_val=2, n_test=2, H=H, W=W, device="cpu")
    d0 = load_blender(scene, half_res=False, testskip=1)
    exps = {}
    for name, from_flags, build in (
            ("jax", J.config.experiment_from_flags, j_driver.build_experiment),
            ("port", experiment_from_flags,
             lambda cfg, expdir: t_driver.build_experiment(cfg, expdir, device="cpu"))):
        workdir = os.path.join(root, name)
        flags = t_soak.soak_flags(scene, workdir, args.steps, small=True, **protocol(args))
        cfg = from_flags(dict(flags, seed=args.seed), warn=lambda *a: None)
        expdir = os.path.join(workdir, "soak")
        os.makedirs(expdir)
        t_soak.write_exact_matches(os.path.join(expdir, "matches.npz"), d0.gt_poses,
                                   d0.i_split[0], d0.gt_intrinsic[0, 0], H, W)
        exps[name] = build(cfg, expdir)
    j_exp, t_exp = exps["jax"], exps["port"]
    params = bridge.train_params_to_torch(jax.tree.map(np.asarray, j_exp.state.params),
                                          device="cpu")
    t_exp.state = create_train_state(params, t_exp.optimizer)
    start = {n: getattr(t_exp.state.params["camera"], n).detach().clone()
             for n in TRAINABLE_LEAVES}
    # The control: the JAX step against itself from parameters one float32
    # ulp apart (each entry of every leaf, a random direction).
    ulp_rng = np.random.default_rng(args.seed + 1)
    ctrl = j_exp.state.replace(params=jax.tree.map(
        lambda x: jax.numpy.asarray(_one_ulp(np.asarray(x), ulp_rng)), j_exp.state.params))

    rs = t_exp.render_cfg
    rng = np.random.default_rng(args.seed)
    n_rand = t_exp.cfg.sampling.N_rand
    key = jax.random.key(0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        use_prd = it >= j_exp.curriculum.add_prd and it % prd_cadence_at(it, t_exp.curriculum) == 0
        batch = j_driver.sample_batch(j_exp, it)
        if use_prd:
            batch = dict(batch, **j_driver.sample_prd_batch(j_exp))
        batch = {k: np.asarray(v) for k, v in batch.items()}
        batch["rands"] = {
            "t": rng.random((n_rand, rs.n_samples)).astype(np.float32),
            "noise0": rng.normal(size=(n_rand, rs.n_samples)).astype(np.float32),
            "noise1": rng.normal(size=(n_rand, rs.n_samples + rs.n_importance)).astype(np.float32),
            "u": rng.random((n_rand, rs.n_importance)).astype(np.float32)}
        j_fn, t_fn = ((j_exp.step_prd_fn, t_exp.step_prd_fn) if use_prd
                      else (j_exp.step_fn, t_exp.step_fn))
        j_batch = jax.tree.map(jax.numpy.asarray, batch)
        j_exp.state, jm = jax.block_until_ready(j_fn(j_exp.state, j_batch, key))
        ctrl, cm = jax.block_until_ready(j_fn(ctrl, j_batch, key))
        t_exp.state, tm = t_fn(t_exp.state, jax.tree.map(_to_port, batch), gen)
        step = it + 1
        if step % args.every and step != args.steps:
            continue
        j_cam = jax.tree.map(np.asarray, j_exp.state.params["camera"])
        t_cam = t_exp.state.params["camera"]
        leaves = {}
        c_cam = jax.tree.map(np.asarray, ctrl.params["camera"])
        for n in TRAINABLE_LEAVES:
            a = getattr(t_cam, n).detach().numpy()
            b = np.asarray(getattr(j_cam, n))
            leaves[n] = {"gap": float(np.linalg.norm(a - b)),
                         "ulp_gap": float(np.linalg.norm(np.asarray(getattr(c_cam, n)) - b)),
                         "moved": float(np.linalg.norm(b - start[n].numpy()))}
        row = {
            "step": step, "prd": bool(use_prd),
            "loss": {"jax": float(jm["loss"]), "port": float(tm["loss"]),
                     "jax_ulp": float(cm["loss"])},
            "focal": {"jax": float(np.asarray(J.get_intrinsic(j_exp.state.params["camera"]))[0, 0]),
                      "port": float(get_intrinsic(host_camera(t_cam))[0, 0])},
            "camera_errors": {"jax": _jax_camera_errors(j_exp),
                              "port": t_soak.camera_errors(t_exp)},
            "leaves": leaves,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"mode": "lockstep", "seed": args.seed, "steps": args.steps,
            "protocol": protocol(args), "gt_focal": float(d0.gt_intrinsic[0, 0]),
            "seconds": round(time.perf_counter() - t0, 1), "rows": rows}


@contextlib.contextmanager
def seeded(module, name, seed):
    """``module.name`` (an ``experiment_from_flags``) with ``seed`` added to
    its flags while the block runs."""
    orig = getattr(module, name)
    setattr(module, name, lambda flags, **kw: orig(dict(flags, seed=seed), **kw))
    try:
        yield
    finally:
        setattr(module, name, orig)


def sweep(args) -> dict:
    J = _jax() if "jax" in args.packages else None
    rows = []
    for seed in args.seeds:
        for pkg in args.packages:
            workdir = tempfile.mkdtemp(prefix=f"soak_sweep_{pkg}_{seed}_")
            kwargs = dict(small=not args.full, eval_every=args.eval_every, **protocol(args))
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                if pkg == "jax":
                    with seeded(J.config, "experiment_from_flags", seed):
                        report = J.soak.main(args.steps, None, workdir, **kwargs)
                else:
                    with seeded(t_soak, "experiment_from_flags", seed):
                        report = t_soak.main(args.steps, None, workdir, device=args.device,
                                             **kwargs)
            q = report["quality"]
            row = {"seed": seed, "package": pkg,
                   "device": "cpu" if pkg == "jax" else t_soak.device_name(torch.device(args.device)),
                   "heldout_psnr": q["heldout_psnr_final"],
                   "camera_err_initial": q["camera_err_initial"],
                   "camera_err_final": q["camera_err_final"],
                   "curve": [{k: r[k] for k in ("step", "psnr", *ERR_KEYS) if k in r}
                             for r in report["eval_curve"]],
                   "seconds": round(time.perf_counter() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"mode": "sweep", "steps": args.steps, "full": args.full, "protocol": protocol(args),
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("lockstep", "sweep"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--seeds", type=int, nargs="+", default=[777, 1, 2, 3, 4])
    ap.add_argument("--camera_lr_mult", type=float, default=8.0)
    ap.add_argument("--camera_lr_until", type=int, default=5000)
    ap.add_argument("--add_prd", type=int, default=2000)
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=["jax", "port"])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="the port's device in a sweep")
    ap.add_argument("--full", action="store_true",
                    help="the soak's full shapes (120x160, 8x256, N_rand 1024, 64+64): "
                         "for the port on the card")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.mode == "lockstep" and (args.full or args.device != "cpu"):
        ap.error("lockstep runs both packages on the CPU at the small shapes")
    torch.set_num_threads(4)
    if args.steps is None:
        args.steps = 300 if args.mode == "lockstep" else 1000
    report = lockstep(args) if args.mode == "lockstep" else sweep(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
