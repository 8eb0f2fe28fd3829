"""The port's NeRF serving path, ``serve.py:RenderService`` over
``make_nerf_serve_fn`` at the configuration's eval settings (NDC with the
scene's focal, batch ``chunk``), driven as the reference's ``render_only``
and video render drive rendering: whole frames along the LLFF loader's
spiral render path, one after another.

Set-up draws the scene's poses as the LLFF loader makes them, and its
spiral render path (``reference/llff.py``), builds the serve function with
the seeded weights and warms it up with ``warmup_frames`` frames. A request
is one whole frame: every pixel's world ray in raster order, made on the
host by the client from the path's next pose and sent as ``RenderService``
takes it (host rays, near and far). Each seed starts at its own pose of the
path; every frame has the same size. The window renders frames until its
seconds are up. The check renders with the reference ``checked_rays``
pixels in all, as many of every finished frame, drawn from the seed.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import scene as scenes
from portbench import training
from portbench.harness import device_info, flags_of, host_report, host_usage
from portbench.metrics import counts
from portbench.metrics.peaks import FP32_FLOP_PER_S, TF32_FLOP_PER_S
from portbench.reference.llff import llff_poses
from portbench.trace import traced

K1 = "scnerf_tpu_torch::sample_pdf"


def pixel_dirs(H: int, W: int, focal: float) -> np.ndarray:
    """Each pixel's camera-frame direction ``(H*W, 3)``, raster order, as
    the pinhole ``get_rays`` makes it."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -np.ones_like(i)], -1)
    return dirs.reshape(-1, 3).astype(np.float32)


def frame_rays(dirs: np.ndarray, c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The world rays ``(origins, directions)`` of a frame at pose ``c2w``."""
    rays_d = dirs @ c2w[:3, :3].T.astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3].astype(np.float32), rays_d.shape).copy()
    return rays_o, np.ascontiguousarray(rays_d)


class Path:
    """The frames' poses: the render path, from a seeded start, in order."""

    def __init__(self, seed: int, poses: np.ndarray):
        self.poses = poses
        self.at = int(np.random.RandomState(seed).randint(len(poses)))

    def next(self) -> int:
        i = self.at
        self.at = (self.at + 1) % len(self.poses)
        return i


def prepare(run) -> dict:
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
    from scnerf_tpu_torch.render.renderer import RenderConfig
    from scnerf_tpu_torch.serve import RenderService, make_nerf_serve_fn
    from scnerf_tpu_torch.train.optim import named_leaves

    flags = flags_of(run.config)
    sc = run.config["scene"]
    H, W = sc["H"], sc["W"]
    rows = scenes.fern_poses_bounds(np.random.RandomState(run.sub_seed("scene")), sc)
    lf = llff_poses(rows, H, W, flags["factor"], flags["llffhold"])
    focal = lf["focal"]
    dirs = pixel_dirs(H, W, focal)
    model_cfg = NeRFConfig(depth=flags["netdepth"], width=flags["netwidth"],
                           multires=flags["multires"], multires_views=flags["multires_views"],
                           use_viewdirs=flags["use_viewdirs"])
    render_cfg = RenderConfig(
        n_samples=flags["N_samples"], n_importance=flags["N_importance"],
        perturb=flags["perturb"], lindisp=flags["lindisp"],
        raw_noise_std=flags["raw_noise_std"], white_bkgd=flags["white_bkgd"],
        use_viewdirs=flags["use_viewdirs"], chunk=flags["chunk"])
    params = {"coarse": init_nerf_mlp(model_cfg, device=run.device),
              "fine": init_nerf_mlp(model_cfg, device=run.device)}
    leaves = named_leaves(params)
    weights = training.seeded_leaves({k: tuple(v.shape) for k, v in leaves.items()},
                                     run.sub_seed("weights"), {}, run.device)
    training.write_leaves(leaves, weights)
    service = RenderService(make_nerf_serve_fn(params, model_cfg, render_cfg,
                                               ndc=(H, W, focal, focal)),
                            batch=flags["chunk"], device=run.device)
    near = np.zeros((H * W,), np.float32)
    far = np.ones((H * W,), np.float32)
    poses = lf["render_poses"]

    def send(i: int) -> dict:
        return service(*frame_rays(dirs, poses[i]), near, far)

    warm = Path(run.sub_seed("warmup"), poses)
    for _ in range(run.mix["warmup_frames"]):
        send(warm.next())
    training.sync(run.device)
    return {"flags": flags, "poses": poses, "dirs": dirs, "focal": focal, "H": H, "W": W,
            "send": send, "weights": weights, "path": Path(run.sub_seed("frames"), poses)}


def window(prep: dict, seconds: float) -> dict:
    """Frames one after another, each sent when the last one's maps are in
    hand, until ``seconds`` have passed."""
    send, path = prep["send"], prep["path"]
    done, rgbs = [], []
    t0 = time.perf_counter()
    while True:
        i = path.next()
        out = send(i)
        end = time.perf_counter()
        done.append(i)
        rgbs.append(out["rgb"])
        if end - t0 >= seconds:
            break
    return {"seconds": end - t0, "frames": done, "rgbs": rgbs}


def reference_rgb(flags: dict, focal: float, H: int, W: int, weights: dict, rays_o, rays_d,
                  device, *, tf32: bool = False) -> np.ndarray:
    """The reference's rgb of host rays, in blocks of ``chunk`` rays: the
    NeRF cascade in eval mode after the NDC warp, clamped at 1."""
    from portbench.reference import nerf as rnerf
    from portbench.reference import optim as ropt
    from portbench.reference.ndc import ndc_rays
    from portbench.reference.renderer import RenderConfig, render_rays
    from portbench.reference.step import precision

    model_cfg = rnerf.NeRFConfig(depth=flags["netdepth"], width=flags["netwidth"],
                                 multires=flags["multires"],
                                 multires_views=flags["multires_views"],
                                 use_viewdirs=flags["use_viewdirs"])
    render_cfg = RenderConfig(
        n_samples=flags["N_samples"], n_importance=flags["N_importance"],
        lindisp=flags["lindisp"], white_bkgd=flags["white_bkgd"],
        use_viewdirs=flags["use_viewdirs"]).eval_mode()
    params = {"coarse": rnerf.init_nerf_mlp(model_cfg, device=device),
              "fine": rnerf.init_nerf_mlp(model_cfg, device=device)}
    training.write_leaves(ropt.named_leaves(params), weights)
    out = []
    with precision(tf32), torch.inference_mode():
        for a in range(0, len(rays_o), flags["chunk"]):
            ro = torch.from_numpy(rays_o[a:a + flags["chunk"]]).to(device)
            rd = torch.from_numpy(rays_d[a:a + flags["chunk"]]).to(device)
            viewdirs = rd / (torch.linalg.vector_norm(rd, dim=-1, keepdim=True) + 1e-10)
            ro, rd = ndc_rays(H, W, focal, focal, 1.0, ro, rd)
            rgb = render_rays(params, model_cfg, render_cfg, ro, rd, viewdirs, 0.0, 1.0)["rgb"]
            out.append(torch.clamp(rgb, max=1.0).cpu().numpy())
    return np.concatenate(out)


def checked_pixels(seed: int, frames: int, n_pixels: int, total: int) -> list[np.ndarray]:
    """About ``total`` pixels in all, as many distinct pixel indices of each
    of ``frames`` frames, drawn from ``seed``, in raster order: a run and a
    short calibration window compare as many pixels."""
    rng = np.random.RandomState(seed)
    k = min(-(-total // frames), n_pixels)
    return [np.sort(rng.choice(n_pixels, k, replace=False)) for _ in range(frames)]


def sampled(prep: dict, pixels: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """The world rays of the checked pixels of the window's frames, in one
    block."""
    rays = [frame_rays(prep["dirs"][p], prep["poses"][i])
            for i, p in zip(prep["window"]["frames"], pixels)]
    return np.concatenate([o for o, _ in rays]), np.concatenate([d for _, d in rays])


def gaps(prep: dict, served: np.ndarray, device, tf32: bool = False,
         reference: np.ndarray | None = None) -> dict:
    """``|served - reference|`` over the rgb of the checked pixels: the
    median and the largest. ``served`` is the rgb to judge; ``reference``
    the reference's, rendered here where not given."""
    if reference is None:
        o, d = sampled(prep, prep["pixels"])
        reference = reference_rgb(prep["flags"], prep["focal"], prep["H"], prep["W"],
                                  prep["weights"], o, d, device, tf32=tf32)
    e = np.abs(served.astype(np.float64) - reference).reshape(-1)
    return {"rgb_median_err": float(np.median(e)), "rgb_max_err": float(e.max())}


def served_pixels(w: dict, pixels: list[np.ndarray]) -> np.ndarray:
    """The served rgb of the checked pixels, in one block."""
    return np.concatenate([rgb[p] for rgb, p in zip(w["rgbs"], pixels)])


def run(run) -> dict:
    prep = prepare(run)
    run.setup_done()
    flags = prep["flags"]
    usage = host_usage()
    w = window(prep, run.seconds)
    host = host_report(usage, host_usage(), w["seconds"])
    prep["window"] = w
    n_pixels = prep["H"] * prep["W"]
    rays = n_pixels * len(w["frames"])
    ray_flops = counts.nerf_ray_forward_flops(flags)
    stats = {"seconds": w["seconds"], "frames": len(w["frames"]), "flops": rays * ray_flops}
    rays_per_s = rays / w["seconds"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    batch = flags["chunk"]
    slices = -(-n_pixels // batch)
    print(f"window: {len(w['frames'])} frames of {n_pixels} rays ({slices} slices of {batch} "
          f"each) in {w['seconds']:.3f} s, {rays_per_s:.1f} rays/s, "
          f"{w['seconds'] / len(w['frames']) * 1e3:.3f} ms a frame; model FLOPs {ray_flops} "
          f"a ray; against the float32 peak {stats['flops'] / w['seconds'] / FP32_FLOP_PER_S:.3%}"
          f", against TF32 {stats['flops'] / w['seconds'] / TF32_FLOP_PER_S:.3%}; peak memory "
          f"{peak} bytes; {host}", flush=True)
    trace = None
    if run.trace:
        n = run.mix["traced_frames"]
        trace = traced(lambda: [prep["send"](prep["path"].next()) for _ in range(n)],
                       run.tmpdir)
        trace["units"] = n
        k1 = counts.resample_bytes(batch, flags["N_samples"], flags["N_importance"])
        trace["op_bytes"] = {K1: n * slices * k1}
        print(f"traced: {n} frames, {n * slices} slices, {trace['kernels']} kernels, "
              f"{trace['kernel_s']:.6f} s of device time in {trace['window_s']:.6f} s, busy "
              f"{trace['busy_s']:.6f} s; K1 {k1} bytes a slice, "
              f"{trace['op_device_s'].get(K1)} s under {K1}", flush=True)
    prep["pixels"] = checked_pixels(run.sub_seed("check"), len(w["frames"]), n_pixels,
                                    run.mix["checked_rays"])
    served = served_pixels(w, prep["pixels"])
    w["rgbs"] = None
    prep["send"] = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    values = gaps(prep, served, run.device)
    print(f"check: {len(served)} pixels of {len(w['frames'])} frames, rgb median error "
          f"{values['rgb_median_err']!r} (not compared: the control reads 0 on some seeds)",
          flush=True)
    return {"end_to_end": {"serve_rays_per_s": rays_per_s},
            "window": stats, "trace": trace, "attempted": len(w["frames"]), "failed": 0,
            "device": device_info(run.device, peak),
            "checks": training.checks({k: values[k] for k in run.limits}, run.limits)}
