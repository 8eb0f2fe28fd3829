"""The NeRF training loop of the port, ``train/driver.py:train_loop``, as
``cli/train.py`` calls it, one step a call.

Set-up writes the seeded LLFF scene and its ``matches.npz`` into the run's
directory, builds the experiment from the configuration's flags
(``build_experiment``), writes the seeded leaves into it, puts its step (and
Adam's count, as a resume would) at the mix's ``start_step``, runs the
checked steps (recorded) and the warm-up steps through ``train_loop``. The
window then calls ``train_loop`` until its seconds are up. The reference
(``portbench/reference``) follows the checked steps from the same leaves,
with the batches' pixel draws and pairs and its own scene, camera, targets
and matches; the draws themselves are checked apart (``training.py``).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from portbench import scene as scenes
from portbench import training
from portbench.harness import flags_of
from portbench.metrics import counts

K1 = "scnerf_tpu_torch::sample_pdf"


def prd_at(flags: dict):
    """Whether the loop takes a PRD step at iteration ``it``."""
    on = flags["ray_loss_type"] == "proj_ray_dist" and flags["camera_model"] != "none"

    def at(it: int) -> bool:
        return on and it >= flags["add_prd"] and it % max(flags["i_ray_dist_loss"], 1) == 0
    return at


def write_scene(run, flags: dict) -> tuple[dict, dict, str, str]:
    """The scene, its matches and the scene and experiment directories."""
    sc = run.config["scene"]
    scene_dir = os.path.join(run.tmpdir, "scene")
    expdir = os.path.join(run.tmpdir, "exp")
    os.makedirs(expdir, exist_ok=True)
    scene = scenes.write_fern_scene(scene_dir, run.sub_seed("scene"), sc, flags["factor"],
                                    flags["llffhold"])
    matches = scenes.projected_matches(scene["poses"][scene["i_train"]], scene["K"], sc["H"],
                                       sc["W"], sc["match_points"], run.sub_seed("matches"))
    scenes.save_matches(os.path.join(expdir, "matches.npz"), matches)
    return scene, matches, scene_dir, expdir


def prepare(run) -> dict:
    """Set-up up to the window: the experiment, its recorder's record and a
    ``call()`` of one loop step."""
    from scnerf_tpu_torch.core.config import experiment_from_flags
    from scnerf_tpu_torch.train import driver as program
    from scnerf_tpu_torch.train.optim import trainable_leaves

    flags = flags_of(run.config)
    scene, matches, scene_dir, expdir = write_scene(run, flags)
    program_seed = run.sub_seed("program")
    cfg = experiment_from_flags(
        {**flags, "datadir": scene_dir, "basedir": run.tmpdir, "expname": "exp",
         "seed": program_seed}, warn=lambda m: print(m, file=sys.stderr))
    exp = program.build_experiment(cfg, expdir, device=run.device)
    leaves = trainable_leaves(exp.state.params)
    weights = training.seeded_leaves({k: tuple(v.shape) for k, v in leaves.items()},
                                     run.sub_seed("weights"), run.mix["camera_noise"],
                                     run.device)
    training.write_leaves(leaves, weights)
    start = run.mix["start_step"]
    exp.state.step = exp.state.opt_state.count = start
    ckpt_dir = os.path.join(run.tmpdir, "ckpts")

    def call():
        program.train_loop(exp, exp.state.step + 1, ckpt_dir=ckpt_dir)

    recorder = training.Recorder(exp, run.mix["checked_steps"], trainable_leaves)
    for _ in range(run.mix["checked_steps"]):
        call()
    recorder.detach()
    for _ in range(run.mix["warmup_steps"]):
        call()
    training.sync(run.device)
    _, H, W, _ = scene["images"].shape
    return {"exp": exp, "call": call, "flags": flags, "scene": scene, "matches": matches,
            "weights": weights, "program_seed": program_seed, "start": start,
            "recorder": recorder, "draw": {"H": H, "W": W, "n_images": len(scene["i_train"])}}


def pad_pair(matches: dict, i: int, j: int, n: int):
    """The matches of images ``i`` and ``j`` (either order), padded to ``n``
    rows with a mask, as the port's ``pad_matches`` pads them."""
    k0, k1 = matches[(i, j)] if i < j else matches[(j, i)][::-1]
    m = min(len(k0), n)
    kps0, kps1 = np.zeros((n, 2), np.float32), np.zeros((n, 2), np.float32)
    kps0[:m], kps1[:m] = k0[:m], k1[:m]
    mask = np.zeros((n,), bool)
    mask[:m] = True
    return torch.from_numpy(kps0), torch.from_numpy(kps1), torch.from_numpy(mask)


def reference_state(flags: dict, scene: dict, weights: dict, start: int, device, tf32: bool):
    """The reference's train state and step functions (plain and PRD, by
    ``False`` and ``True``), built from the configuration's flags, the
    scene's poses and the seeded leaves."""
    from portbench.reference import camera as rcam
    from portbench.reference import curriculum as rcur
    from portbench.reference import nerf as rnerf
    from portbench.reference import optim as ropt
    from portbench.reference import renderer as rrender
    from portbench.reference import step as rstep

    model_cfg = rnerf.NeRFConfig(depth=flags["netdepth"], width=flags["netwidth"],
                                 multires=flags["multires"],
                                 multires_views=flags["multires_views"],
                                 use_viewdirs=flags["use_viewdirs"])
    render_cfg = rrender.RenderConfig(
        n_samples=flags["N_samples"], n_importance=flags["N_importance"],
        perturb=flags["perturb"], lindisp=flags["lindisp"],
        raw_noise_std=flags["raw_noise_std"], white_bkgd=flags["white_bkgd"],
        use_viewdirs=flags["use_viewdirs"], chunk=flags["chunk"])
    train_cfg = rstep.TrainConfig(
        lr_init=flags["lrate"], lr_decay_steps=flags["lrate_decay"] * 1000.0,
        weight_decay=flags["non_linear_weight_decay"] if flags["use_custom_optim"] else 0.0,
        use_ndc=not flags["no_ndc"], near=0.0, far=1.0, prd_method="NeRF",
        prd_threshold=flags["proj_ray_dist_threshold"])
    curriculum = rcur.Curriculum(
        add_ie=flags["add_ie"], add_od=flags["add_od"], add_prd=flags["add_prd"],
        i_ray_dist_loss=flags["i_ray_dist_loss"],
        ray_dist_loss_weight=flags["ray_dist_loss_weight"])
    optimizer = ropt.Optimizer(train_cfg.lr_init, train_cfg.lr_decay_steps,
                               decay_factor=train_cfg.lr_decay_factor,
                               weight_decay=train_cfg.weight_decay)
    params = {"coarse": rnerf.init_nerf_mlp(model_cfg, device=device),
              "fine": rnerf.init_nerf_mlp(model_cfg, device=device)
              if flags["N_importance"] > 0 else None}
    for x in ropt.named_leaves(params).values():
        x.requires_grad_(True)
    _, H, W, _ = scene["images"].shape
    cam_cfg = rcam.CameraConfig(
        H=H, W=W, grid_size=flags["grid_size"], convention=rcam.OPENGL,
        use_distortion="dist" in flags["camera_model"],
        multiplicative_noise=flags["multiplicative_noise"],
        intrinsics_noise_scale=flags["intrinsics_noise_scale"],
        ray_o_noise_scale=flags["ray_o_noise_scale"],
        ray_d_noise_scale=flags["ray_d_noise_scale"],
        extrinsics_noise_scale=flags["extrinsics_noise_scale"])
    params["camera"] = rcam.trainable_camera(rcam.init_camera(
        scene["K"], scene["poses"][scene["i_train"]], cam_cfg, device=device))
    training.write_leaves(ropt.trainable_leaves(params), weights)
    state = rstep.TrainState(step=start, params=params, opt_state=optimizer.init(params))
    state.opt_state.count = start
    steps = {prd: rstep.make_step_fn(
        rstep.nerf_loss_fn(model_cfg, render_cfg, train_cfg, curriculum, with_prd=prd),
        curriculum, optimizer, tf32=tf32) for prd in (False, True)}
    return state, steps, optimizer


def reference_record(prep: dict, device, *, tf32: bool = False, fault=None) -> dict:
    """The reference over the checked steps: each step's pixels (and pair)
    as the program drew them, its targets from the scene's images, its
    matches from the benchmark's; losses, Adam's first moment after the
    first step, the leaves before and after. ``fault(batch) -> batch``
    plants a fault in the reference's feed (for the controls)."""
    from portbench.reference import optim as ropt
    from portbench.reference import step as rstep

    flags, scene, matches = prep["flags"], prep["scene"], prep["matches"]
    state, steps, optimizer = reference_state(flags, scene, prep["weights"], prep["start"],
                                              device, tf32)
    images = torch.from_numpy(scene["images"].astype(np.float32) / np.float32(255.0))
    i_train = torch.from_numpy(scene["i_train"])
    at = prd_at(flags)
    losses, mu1 = [], None
    before = {k: v.detach().clone() for k, v in ropt.trainable_leaves(state.params).items()}
    for call in prep["calls"]:
        it = state.step
        b = call["batch"]
        px, py, ci = (b[k].long().cpu() for k in ("px", "py", "img_idx"))
        batch = {"px": b["px"], "py": b["py"], "img_idx": b["img_idx"],
                 "target": images[i_train[ci], py, px].to(device)}
        prd = at(it)
        if prd:
            if "pair_idx" not in b:
                return {"losses": []}
            i, j = (int(x) for x in b["pair_idx"].cpu())
            kps0, kps1, mask = pad_pair(matches, i, j, flags["match_num"])
            batch.update(kps0=kps0.to(device), kps1=kps1.to(device), kp_mask=mask.to(device),
                         pair_idx=torch.tensor([i, j], device=device))
        if fault is not None:
            batch = fault(batch)
        gen = rstep.step_generator(prep["program_seed"], it, device)
        state, metrics = steps[prd](state, batch, gen)
        losses.append(float(metrics["loss"]))
        if mu1 is None:
            mu1 = {k: v.clone() for k, v in state.opt_state.mu.items()}
    after = {k: v.detach().clone() for k, v in ropt.trainable_leaves(state.params).items()}
    return {"losses": losses, "mu1": mu1, "before": before, "after": after,
            "b1": optimizer.b1}


def run(run) -> dict:
    prep = prepare(run)
    run.setup_done()
    flags = prep["flags"]
    return training.measure(
        run, prep, prd_at(flags),
        ray_flops=counts.train_flops_per_step(counts.nerf_ray_forward_flops(flags), 1),
        operator=K1,
        operator_bytes=counts.resample_bytes(flags["N_rand"], flags["N_samples"],
                                             flags["N_importance"]),
        reference_record=reference_record)
