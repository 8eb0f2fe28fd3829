"""The port's NeRF++ serving path, ``serve.py:RenderService`` over
``make_nerfpp_serve_fn`` at the configuration's eval settings (its cascade,
no jitter, batch ``chunk_size``), driven as NeRF++'s ``ddp_test_nerf.py``
renders the test views of a trained unbounded scene: whole frames, one
after another.

Set-up draws the test views' poses as ``portbench/scene.py:nerfpp_poses``
draws a Truck scene's views (the configuration's K, ``test_views`` of them,
under their own sub-seed) and makes each view's rays on the host, as the
NeRF++ loader's ``get_rays_single_image`` makes them when it loads a split
(pixel centres through ``K^-1``, OpenCV's convention, not normalised);
then it builds the serve function with the seeded weights and warms it up
with ``warmup_frames`` frames. A request is one whole frame: a view's
world rays in raster order, and ``min_depth`` 1e-4, the loader's value
where a scene has no min-depth maps.
Each seed starts at its own view; every frame has the same size. The
window renders frames until its seconds are up. The check renders with the
reference (``reference/nerfpp_renderer.py``, TF32 off, in blocks of
``chunk_size``) ``checked_rays`` pixels in all, as many of every finished
frame, drawn from the seed, and compares the last level's rgb. The
selection of pixels, the window and the rays of the checked pixels are
``serve_nerf.py``'s.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import scene as scenes
from portbench import training
from portbench.drivers.serve_nerf import (Path, checked_pixels, frame_rays, sampled,
                                          served_pixels, window)
from portbench.harness import device_info, flags_of, host_report, host_usage
from portbench.metrics import counts
from portbench.metrics.peaks import FP32_FLOP_PER_S, TF32_FLOP_PER_S
from portbench.trace import traced

K2 = "scnerf_tpu_torch::sample_pdf_fwd"
K3 = "scnerf_tpu_torch::fused_query_field"
MIN_DEPTH = 1e-4  # the loader's fg near bound where a scene has no min-depth maps


def pixel_dirs(K: np.ndarray, H: int, W: int) -> np.ndarray:
    """Each pixel's camera-frame direction ``(H*W, 3)``, raster order:
    ``K^-1 (u + 0.5, v + 0.5, 1)``, as ``get_rays_single_image`` makes it."""
    v, u = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")
    pixels = np.stack([u + 0.5, v + 0.5, np.ones_like(u)], -1).reshape(-1, 3)
    return (pixels @ np.linalg.inv(K[:3, :3]).T).astype(np.float32)


def levels_of(flags: dict) -> tuple[list, int]:
    """The cascade's samples a level and the rays a slice."""
    return list(flags["cascade_samples"])[:flags["cascade_level"]], flags["chunk_size"]


def k2_bytes_per_slice(flags: dict) -> int:
    """K2's bytes a served slice: at each later level, the fg and the bg
    resample, forward only."""
    samples, batch = levels_of(flags)
    total, depths = 0, samples[0]
    for s in samples[1:]:
        total += 2 * counts.resample_bytes(batch, depths, s)
        depths += s
    return total


def k3_flops_per_slice(flags: dict) -> int:
    """The model FLOPs a served slice of the last level's fg and bg fields,
    the queries the serve function sends through K3: each net on every
    sample of that level (two FLOPs a multiply-add)."""
    samples, batch = levels_of(flags)
    depth, width = flags["netdepth"], flags["netwidth"]
    view = counts.positional_dim(3, flags["max_freq_log2_viewdirs"])
    macs = sum(counts.mlpnet_point_macs(depth, width, (4,),
                                        counts.positional_dim(dim, flags["max_freq_log2"]), view)
               for dim in (3, 4))
    return 2 * macs * sum(samples) * batch


def prepare(run) -> dict:
    from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net
    from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig
    from scnerf_tpu_torch.serve import RenderService, make_nerfpp_serve_fn
    from scnerf_tpu_torch.train.optim import named_leaves

    flags = flags_of(run.config)
    sc = run.config["scene"]
    H, W = sc["H"], sc["W"]
    K, poses = scenes.nerfpp_poses(np.random.RandomState(run.sub_seed("test_views")),
                                   run.mix["test_views"], sc)
    dirs = pixel_dirs(K, H, W)
    samples, batch = levels_of(flags)
    model_cfg = NerfPPConfig(depth=flags["netdepth"], width=flags["netwidth"],
                             max_freq_log2=flags["max_freq_log2"],
                             max_freq_log2_viewdirs=flags["max_freq_log2_viewdirs"])
    render_cfg = NerfPPRenderConfig(cascade_samples=tuple(samples), perturb=False, chunk=batch)
    params = {"levels": [init_nerfpp_net(model_cfg, device=run.device) for _ in samples]}
    leaves = named_leaves(params)
    weights = training.seeded_leaves({k: tuple(v.shape) for k, v in leaves.items()},
                                     run.sub_seed("weights"), {}, run.device)
    training.write_leaves(leaves, weights)
    service = RenderService(make_nerfpp_serve_fn(params["levels"], model_cfg, render_cfg),
                            batch=batch, device=run.device)
    min_depth = np.full((H * W,), MIN_DEPTH, np.float32)
    rays = [frame_rays(dirs, c2w) for c2w in poses]

    def send(i: int) -> dict:
        return service(*rays[i], min_depth)

    warm = Path(run.sub_seed("warmup"), poses)
    for _ in range(run.mix["warmup_frames"]):
        send(warm.next())
    training.sync(run.device)
    return {"flags": flags, "poses": poses, "dirs": dirs, "focal": sc["focal"], "H": H, "W": W,
            "send": send, "weights": weights, "path": Path(run.sub_seed("frames"), poses)}


def reference_rgb(flags: dict, focal: float, H: int, W: int, weights: dict, rays_o, rays_d,
                  device, *, tf32: bool = False) -> np.ndarray:
    """The reference's last-level rgb of host rays, in blocks of
    ``chunk_size`` rays: the NeRF++ cascade in eval mode from ``min_depth``
    1e-4 (``focal``, ``H`` and ``W`` are in the rays already)."""
    from portbench.reference import nerfpp as rnerfpp
    from portbench.reference import optim as ropt
    from portbench.reference.nerfpp_renderer import NerfPPRenderConfig, render_rays_nerfpp
    from portbench.reference.step import precision

    samples, batch = levels_of(flags)
    model_cfg = rnerfpp.NerfPPConfig(depth=flags["netdepth"], width=flags["netwidth"],
                                     max_freq_log2=flags["max_freq_log2"],
                                     max_freq_log2_viewdirs=flags["max_freq_log2_viewdirs"])
    render_cfg = NerfPPRenderConfig(cascade_samples=tuple(samples), perturb=False, chunk=batch)
    params = {"levels": [rnerfpp.init_nerfpp_net(model_cfg, device=device) for _ in samples]}
    training.write_leaves(ropt.named_leaves(params), weights)
    out = []
    with precision(tf32), torch.inference_mode():
        for a in range(0, len(rays_o), batch):
            ro = torch.from_numpy(rays_o[a:a + batch]).to(device)
            rd = torch.from_numpy(rays_d[a:a + batch]).to(device)
            md = torch.full((ro.shape[0],), MIN_DEPTH, device=device)
            last = render_rays_nerfpp(params["levels"], model_cfg, render_cfg, ro, rd, md)[-1]
            out.append(last["rgb"].cpu().numpy())
    return np.concatenate(out)


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
    ray_flops = counts.nerfpp_ray_forward_flops(flags)
    stats = {"seconds": w["seconds"], "frames": len(w["frames"]), "flops": rays * ray_flops}
    rays_per_s = rays / w["seconds"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    _, batch = levels_of(flags)
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
        k2, k3 = k2_bytes_per_slice(flags), k3_flops_per_slice(flags)
        trace["op_bytes"] = {K2: n * slices * k2}
        trace["op_flops"] = {K3: n * slices * k3}
        print(f"traced: {n} frames, {n * slices} slices, {trace['kernels']} kernels, "
              f"{trace['kernel_s']:.6f} s of device time in {trace['window_s']:.6f} s, busy "
              f"{trace['busy_s']:.6f} s; K2 {k2} bytes a slice, "
              f"{trace['op_device_s'].get(K2)} s under {K2}; K3 {k3} FLOPs a slice, "
              f"{trace['op_device_s'].get(K3)} s under {K3}", flush=True)
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
          f"{values['rgb_median_err']!r} (not compared)", flush=True)
    return {"end_to_end": {"serve_rays_per_s": rays_per_s},
            "window": stats, "trace": trace, "attempted": len(w["frames"]), "failed": 0,
            "device": device_info(run.device, peak),
            "checks": training.checks({k: values[k] for k in run.limits}, run.limits)}
