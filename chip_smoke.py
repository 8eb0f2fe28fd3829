"""Drive the PyTorch port's NeRF and NeRF++ serving paths once on an NVIDIA
card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports neither JAX nor
the JAX package. Phases, each of which exits non-zero when it fails:

1. The card's name and power limit, the versions, and the kernels' build
   from ``scnerf_tpu_torch/csrc`` (timed).
2. K1, the inverse-CDF CUDA kernel, against its plain PyTorch twin on the
   card at the serving shapes (8192 rays; 63, 62 and 64 bins; 64 samples;
   deterministic and random u): median |err| < 1e-6, under 0.1% of samples
   off by more than 1e-4 (boundary flips), every output within the bins
   (1e-5 slack). Time per call of both, from CUDA events around 50
   back-to-back calls (median of 5).
3. The serving slice at full width: the fern model (NeRF 8x256, skip at 4,
   viewdirs, multires 10/4, 64+64 samples) with seeded random weights, the
   learnable OpenGL camera at 756x1008 with 10-px noise grids, the NDC warp
   with the learned focal, eval mode, behind a RenderService of batch 8192.
   Three requests: 1,000 random pixels, 65,536 random pixels and one full
   image. Outputs must be finite, rgb and acc in [0, 1], shapes right, and
   the kernel's launch count must cover every chunk served.
4. The card against the CPU port: 1,024 of those rays through the same
   serve function on the CPU (which takes the plain twin): rgb median
   |err| < 1e-5 and max < 1e-3.
5. K2, the NeRF++ inverse-CDF CUDA kernel under its autograd function,
   against its plain twin on the card: the serving shape (4096 rays, 63 bins,
   128 samples), 62 and 64 bins, deterministic and random u, and ragged
   sizes, with empty rays and empty bins; values by phase 2's criterion;
   gradients into bins, weights and u under a random cotangent against the
   twin's autograd (under 0.2% of entries off by more than 1e-4 of the
   largest); time per call of both, as in phase 2.
6. The NeRF++ serving slice at full width: the Tanks&Temples Truck model
   (fg and bg MLPNets 8x256, skip at 4, 10/4 frequencies, cascade 64,128)
   with seeded random weights, the learnable OpenCV camera (pixel offset
   0.5, multiplicative intrinsics noise) at 546x980 with noise on every
   learnable leaf, eval mode, min depth 1e-4, behind a RenderService of
   batch 4096. Three requests: 1,000 random pixels, 65,536 random pixels
   and one full image (131 batches). Outputs must be finite, rgb and
   bg_lambda in [0, 1], shapes right, and K2 launched at least twice per
   batch served. Also the share of rays whose last bin weighs under 1e-6
   (the deterministic u = 1.0 then meets the denominator guard).
7. The card against the CPU port for NeRF++: 512 of those rays: rgb median
   |err| < 1e-5 and max < 1e-3.

Each serving path runs with both kernels' launch counts set to 0 just
before it and read just after. The line before the last is one JSON object
with the kernels' numbers; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 756, 1008
FOCAL = 815.0
N_IMAGES = 8
BATCH = 8192
SEED = 0
PDF_SHAPES = ((BATCH, 63, 64), (BATCH, 62, 64), (BATCH, 64, 64))
TIMING_CALLS = 50
TIMING_REPEATS = 5

# NeRF++: configs/tanks_and_temples/tat_training_Truck_ours.txt at the
# camera of bench.py's NeRF++ workload.
PP_H, PP_W = 546, 980
PP_FOCAL = 580.0
PP_IMAGES = 12
PP_BATCH = 4096  # chunk_size
PP_CASCADE = (64, 128)
PP_SHAPES = ((PP_BATCH, 63, 128), (PP_BATCH, 62, 128), (PP_BATCH, 64, 128))
PP_RAGGED = ((1, 2, 1), (5, 17, 33), (1027, 63, 100))
PP_PIXEL_REQUESTS = (1000, 65536)
PP_CPU_RAYS = 512


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def per_call_ms(fn, calls: int = TIMING_CALLS, repeats: int = TIMING_REPEATS) -> float:
    """Milliseconds per call: CUDA events around ``calls`` back-to-back calls,
    after a warm-up; the median over ``repeats`` such runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rodrigues(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotation matrices ``(n, 3, 3)`` from unit axes and angles."""
    K = np.zeros((len(axis), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    a = angle[:, None, None]
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def phase_kernels(dev):
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.sampling.pdf import pdf_uniforms

    print("== phase 2: K1 sample_pdf kernel against its plain twin on the card")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    record = None
    for n, b, s in PDF_SHAPES:
        bins = np.sort(rng.uniform(2.0, 6.0, (n, b)).astype(np.float32), axis=-1)
        weights = rng.random((n, b - 1)).astype(np.float32)
        weights[: n // 8] = 0.0  # empty rays: the eps makes them uniform
        weights[n // 8: n // 4, ::3] = 0.0  # empty bins: guarded denominators
        bins = torch.from_numpy(bins).to(dev)
        weights = torch.from_numpy(weights).to(dev)
        for det in (True, False):
            u = pdf_uniforms(gen, n, s, det, device=dev)
            got = pdf_cuda.sample_pdf_core(bins, weights, u)
            want = pdf_cuda.sample_pdf_plain(bins, weights, u)
            torch.cuda.synchronize()
            err = (got - want).abs()
            med = float(err.median())
            flips = float((err > 1e-4).float().mean())
            lo = float(got.min()) >= float(bins.min()) - 1e-5
            hi = float(got.max()) <= float(bins.max()) + 1e-5
            ms = per_call_ms(lambda: pdf_cuda.sample_pdf_core(bins, weights, u))
            plain_ms = per_call_ms(lambda: pdf_cuda.sample_pdf_plain(bins, weights, u))
            print(f"  bins ({n},{b}) u ({n},{s}) det={det}: median|err|={med:.3e} "
                  f"max|err|={float(err.max()):.3e} share>1e-4={flips:.2e} "
                  f"in_bins={lo and hi} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            require(med < 1e-6, f"K1 median error {med} at {(n, b, s, det)}")
            require(flips < 1e-3, f"K1 boundary-flip share {flips} at {(n, b, s, det)}")
            require(lo and hi, f"K1 output outside the bins at {(n, b, s, det)}")
            if (b, det) == (63, True):  # the serving path's shape
                record = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms)
    return record


def make_slice(dev):
    from scnerf_tpu_torch.camera import CameraConfig, OPENGL, get_intrinsic, init_camera
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp
    from scnerf_tpu_torch.render.renderer import RenderConfig

    model_cfg = NeRFConfig()  # 8x256, skip (4,), viewdirs, multires 10/4
    render_cfg = RenderConfig(n_samples=64, n_importance=64, chunk=BATCH)
    gen = torch.Generator().manual_seed(SEED)
    params = {
        "coarse": init_nerf_mlp(model_cfg, generator=gen, device=dev),
        "fine": init_nerf_mlp(model_cfg, generator=gen, device=dev),
    }
    rng = np.random.RandomState(SEED)
    axis = rng.randn(N_IMAGES, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    E = np.tile(np.eye(4), (N_IMAGES, 1, 1))
    E[:, :3, :3] = rodrigues(axis, rng.rand(N_IMAGES) * 0.2)
    E[:, :3, 3] = rng.randn(N_IMAGES, 3) * 0.1
    K = np.array([[FOCAL, 0, W / 2, 0], [0, FOCAL, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    camera = init_camera(K, E, CameraConfig(H=H, W=W, convention=OPENGL), device=dev)
    # A camera as calibration leaves it: every learnable leaf non-zero.
    for name, scale in (("intrinsics_noise", 2.0), ("extrinsics_noise", 0.5),
                        ("ray_o_grid", 1.0), ("ray_d_grid", 1.0)):
        leaf = getattr(camera, name)
        noise = torch.randn(leaf.shape, generator=gen) * scale
        setattr(camera, name, noise.to(dev))
    K_learned = get_intrinsic(camera)
    ndc = (H, W, float(K_learned[0, 0]), float(K_learned[1, 1]))
    return model_cfg, render_cfg, params, camera, ndc


def phase_slice(dev, card, slice_):
    from scnerf_tpu_torch.camera import pixels_to_rays, rays_full_image
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.serve import RenderService, make_nerf_serve_fn

    print("== phase 3: serving slice at full fern width on the card")
    model_cfg, render_cfg, params, camera, ndc = slice_
    service = RenderService(make_nerf_serve_fn(params, model_cfg, render_cfg, ndc=ndc),
                            BATCH, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def random_pixels(n):
        px = torch.randint(0, W, (n,), generator=gen, device=dev)
        py = torch.randint(0, H, (n,), generator=gen, device=dev)
        idx = torch.randint(0, N_IMAGES, (n,), generator=gen, device=dev)
        return pixels_to_rays(camera, px, py, image_idx=idx)

    requests = {
        "1000_pixels": random_pixels(1000),
        "65536_pixels": random_pixels(65536),
        "full_image": rays_full_image(camera, image_idx=0),
    }

    def request(rays_o, rays_d):
        n = rays_o.shape[0]
        near = torch.zeros(n, device=dev)
        far = torch.ones(n, device=dev)
        return service(rays_o, rays_d, near, far)

    request(*requests["1000_pixels"])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    pdf_cuda.launches = pdf_cuda.diff_launches = 0
    outputs, rates = {}, {}
    for name, (rays_o, rays_d) in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[name] = request(rays_o, rays_d)  # ends in a device->host copy
        seconds = time.perf_counter() - t0
        rates[name] = rays_o.shape[0] / seconds
    launches = pdf_cuda.launches
    print(f"  K2 launches on the NeRF path: {pdf_cuda.diff_launches}")

    chunks = 0
    for name, (rays_o, _) in requests.items():
        n = rays_o.shape[0]
        chunks += -(-n // BATCH)
        out = outputs[name]
        require(out["rgb"].shape == (n, 3), f"{name}: rgb shape {out['rgb'].shape}")
        for k in ("depth", "acc", "disp"):
            require(out[k].shape == (n,), f"{name}: {k} shape {out[k].shape}")
        for k, v in out.items():
            require(bool(np.isfinite(v).all()), f"{name}: {k} not finite")
        require(out["rgb"].min() >= 0.0 and out["rgb"].max() <= 1.0, f"{name}: rgb outside [0, 1]")
        require(out["acc"].min() >= 0.0 and out["acc"].max() <= 1.0 + 1e-5,
                f"{name}: acc outside [0, 1]")
        print(f"  {name}: {n} rays, {rates[name]:.1f} rays/s ({card}); "
              f"rgb mean {out['rgb'].mean():.4f}, acc mean {out['acc'].mean():.4f}")
    print(f"  pdf_cuda.launches={launches} over {chunks} chunks served")
    require(launches >= chunks, f"K1 launched {launches} times for {chunks} chunks")
    return requests, outputs, launches


def phase_cpu_agreement(slice_, requests, outputs):
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.camera import CAMERA_LEAVES, pixels_to_rays
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.serve import make_nerf_serve_fn

    print("== phase 4: the card against the CPU port")
    model_cfg, render_cfg, params, camera, ndc = slice_
    n = 1024
    rays_o, rays_d = (x[:n].cpu() for x in requests["65536_pixels"])
    cpu_params = bridge.tree_to_torch(bridge.tree_to_numpy(params), device="cpu")
    before = pdf_cuda.launches
    cpu_out = make_nerf_serve_fn(cpu_params, model_cfg, render_cfg, ndc=ndc)(
        rays_o, rays_d, torch.zeros(n), torch.ones(n))
    require(pdf_cuda.launches == before, "the CPU run launched the CUDA kernel")
    err = np.abs(cpu_out["rgb"].numpy() - outputs["65536_pixels"]["rgb"][:n])
    print(f"  rgb over {n} rays: median|err|={np.median(err):.3e} max|err|={err.max():.3e}")
    require(np.median(err) < 1e-5, f"card vs CPU rgb median error {np.median(err)}")
    require(err.max() < 1e-3, f"card vs CPU rgb max error {err.max()}")

    # The camera too: the same pixels through a CPU copy of it.
    cpu_cam = dataclasses.replace(camera, **{k: getattr(camera, k).cpu() for k in CAMERA_LEAVES})
    px = (torch.arange(64) * 7 % W).float()
    py = (torch.arange(64) * 5 % H).float()
    idx = torch.arange(64) % N_IMAGES
    card_rays = pixels_to_rays(camera, px, py, image_idx=idx)
    cpu_rays = pixels_to_rays(cpu_cam, px, py, image_idx=idx)
    cam_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_rays, cpu_rays))
    print(f"  camera rays max|err|={cam_err:.3e}")
    require(cam_err < 1e-5, f"card vs CPU camera ray error {cam_err}")


def resample_inputs(rng, n, b, dev):
    """Sorted bins and weights with empty rays (the eps makes them uniform)
    and empty bins (guarded denominators)."""
    bins = np.sort(rng.uniform(2.0, 6.0, (n, b)).astype(np.float32), axis=-1)
    weights = rng.random((n, b - 1)).astype(np.float32)
    weights[: n // 8] = 0.0
    weights[n // 8: n // 4, ::3] = 0.0
    return torch.from_numpy(bins).to(dev), torch.from_numpy(weights).to(dev)


def check_resample(got, want, bins, what):
    """Phase 2's criterion; returns (median, max) |err|."""
    err = (got - want).abs()
    med = float(err.median())
    flips = float((err > 1e-4).float().mean())
    lo = float(got.min()) >= float(bins.min()) - 1e-5
    hi = float(got.max()) <= float(bins.max()) + 1e-5
    require(med < 1e-6, f"{what}: median error {med}")
    require(flips < 1e-3, f"{what}: boundary-flip share {flips}")
    require(lo and hi, f"{what}: output outside the bins")
    return med, float(err.max()), flips


def phase_k2(dev):
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.sampling.pdf import pdf_uniforms, sample_pdf

    print("== phase 5: K2 sample_pdf_nerfpp kernel against its plain twin on the card")
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    record = None

    def kernel(bins, weights, u):
        with torch.inference_mode():  # as the serving path calls it
            return pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp")

    def plain(bins, weights, u):
        with torch.inference_mode():
            return sample_pdf(None, bins, weights, u.shape[1], u=u, variant="nerfpp")

    def grads(fn, bins, weights, u, cot):
        leaves = [x.clone().requires_grad_() for x in (bins, weights, u)]
        (fn(*leaves) * cot).sum().backward()
        return [x.grad for x in leaves]

    for n, b, s in PP_SHAPES:
        bins, weights = resample_inputs(rng, n, b, dev)
        for det in (True, False):
            what = f"K2 at {(n, b, s)} det={det}"
            u = pdf_uniforms(gen, n, s, det, device=dev)
            got, want = kernel(bins, weights, u), plain(bins, weights, u)
            torch.cuda.synchronize()
            med, mx, flips = check_resample(got, want, bins, what)
            cot = torch.randn(u.shape, generator=gen, device=dev)
            off = []
            for name, gk, gp in zip(("bins", "weights", "u"), grads(
                    lambda b_, w_, u_: pdf_cuda.sample_pdf_diff(b_, w_, u_, "nerfpp"),
                    bins, weights, u, cot), grads(
                    lambda b_, w_, u_: sample_pdf(None, b_, w_, s, u=u_, variant="nerfpp"),
                    bins, weights, u, cot)):
                frac = float(((gk - gp).abs() / (gp.abs().max() + 1e-8) > 1e-4).float().mean())
                off.append(f"{name} {frac:.2e}")
                require(frac < 2e-3, f"{what}: gradient into {name}, {frac} of entries off")
            ms = per_call_ms(lambda: kernel(bins, weights, u))
            plain_ms = per_call_ms(lambda: plain(bins, weights, u))
            print(f"  bins ({n},{b}) u ({n},{s}) det={det}: median|err|={med:.3e} "
                  f"max|err|={mx:.3e} share>1e-4={flips:.2e} grads off: {', '.join(off)}; "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if (b, det) == (63, True):  # the serving path's shape
                record = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms)
    for n, b, s in PP_RAGGED:
        bins, weights = resample_inputs(rng, n, b, dev)
        u = pdf_uniforms(gen, n, s, False, device=dev)
        got, want = kernel(bins, weights, u), plain(bins, weights, u)
        torch.cuda.synchronize()
        med, mx, _ = check_resample(got, want, bins, f"K2 at {(n, b, s)}")
        print(f"  ragged ({n},{b}) u ({n},{s}): median|err|={med:.3e} max|err|={mx:.3e}")
    return record


def make_nerfpp_slice(dev):
    from scnerf_tpu_torch.camera import CameraConfig, OPENCV, init_camera
    from scnerf_tpu_torch.camera.model import get_extrinsics
    from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net
    from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig

    model_cfg = NerfPPConfig()  # 8x256, skip (4,), max_freq_log2 10/4
    render_cfg = NerfPPRenderConfig(cascade_samples=PP_CASCADE, chunk=PP_BATCH,
                                    pdf_impl="pallas_vjp")
    gen = torch.Generator().manual_seed(SEED + 3)
    levels = [init_nerfpp_net(model_cfg, PP_IMAGES, generator=gen, device=dev)
              for _ in PP_CASCADE]
    rng = np.random.RandomState(3)
    K = np.array([[PP_FOCAL, 0, PP_W / 2, 0], [0, PP_FOCAL, PP_H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    axis = rng.randn(PP_IMAGES, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    E = np.tile(np.eye(4), (PP_IMAGES, 1, 1))
    E[:, :3, :3] = rodrigues(axis, rng.rand(PP_IMAGES) * 0.3)
    E[:, :3, 3] = rng.randn(PP_IMAGES, 3) * 0.2
    cfg = CameraConfig(H=PP_H, W=PP_W, convention=OPENCV, pixel_offset=0.5,
                       multiplicative_noise=True)
    camera = init_camera(K, E, cfg, device=dev)
    # A camera as calibration leaves it: every learnable leaf non-zero (the
    # intrinsics noise is relative here: 1% of each of fx, fy, cx, cy).
    for name, scale in (("intrinsics_noise", 0.01), ("extrinsics_noise", 0.5),
                        ("ray_o_grid", 1.0), ("ray_d_grid", 1.0)):
        leaf = getattr(camera, name)
        setattr(camera, name, (torch.randn(leaf.shape, generator=gen) * scale).to(dev))
    centres = torch.linalg.vector_norm(get_extrinsics(camera)[:, :3, 3], dim=-1)
    require(float(centres.max()) < 1.0, f"a camera lies outside the unit sphere: {centres}")
    return model_cfg, render_cfg, levels, camera


def phase_nerfpp_slice(dev, card, slice_):
    from scnerf_tpu_torch.camera import pixels_to_rays, rays_full_image
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.render.nerfpp_renderer import render_rays_nerfpp
    from scnerf_tpu_torch.serve import RenderService, fp32_inference, make_nerfpp_serve_fn

    print("== phase 6: NeRF++ serving slice at full Truck width on the card")
    model_cfg, render_cfg, levels, camera = slice_
    service = RenderService(make_nerfpp_serve_fn(levels, model_cfg, render_cfg),
                            PP_BATCH, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def random_pixels(n):
        px = torch.randint(0, PP_W, (n,), generator=gen, device=dev)
        py = torch.randint(0, PP_H, (n,), generator=gen, device=dev)
        idx = torch.randint(0, PP_IMAGES, (n,), generator=gen, device=dev)
        return pixels_to_rays(camera, px, py, image_idx=idx)

    requests = {f"{n}_pixels": random_pixels(n) for n in PP_PIXEL_REQUESTS}
    requests["full_image"] = rays_full_image(camera, image_idx=0)

    def request(ray_o, ray_d):
        return service(ray_o, ray_d, torch.full((ray_o.shape[0],), 1e-4, device=dev))

    request(*next(iter(requests.values())))  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    pdf_cuda.launches = pdf_cuda.diff_launches = 0
    outputs, rates = {}, {}
    for name, (ray_o, ray_d) in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[name] = request(ray_o, ray_d)  # ends in a device->host copy
        seconds = time.perf_counter() - t0
        rates[name] = ray_o.shape[0] / seconds
    launches = pdf_cuda.diff_launches
    print(f"  K1 launches on the NeRF++ path: {pdf_cuda.launches}")

    batches = 0
    for name, (ray_o, _) in requests.items():
        n = ray_o.shape[0]
        batches += -(-n // PP_BATCH)
        out = outputs[name]
        require(out["rgb"].shape == (n, 3), f"{name}: rgb shape {out['rgb'].shape}")
        for k in ("fg_depth", "bg_lambda"):
            require(out[k].shape == (n,), f"{name}: {k} shape {out[k].shape}")
        for k, v in out.items():
            require(bool(np.isfinite(v).all()), f"{name}: {k} not finite")
        # [0, 1] up to the 1e-6 per sample that TINY_NUMBER adds to each
        # transmittance factor (192 fg samples: at most ~2e-4 above 1).
        for k in ("rgb", "bg_lambda"):
            require(out[k].min() >= 0.0 and out[k].max() <= 1.0 + 1e-3,
                    f"{name}: {k} outside [0, 1]: {out[k].min()}, {out[k].max()}")
        print(f"  {name}: {n} rays, {rates[name]:.1f} rays/s ({card}); "
              f"rgb mean {out['rgb'].mean():.4f}, bg_lambda mean {out['bg_lambda'].mean():.4f}, "
              f"fg_depth mean {out['fg_depth'].mean():.4f}")
    print(f"  pdf_cuda.diff_launches={launches} over {batches} batches served")
    require(launches >= 2 * batches, f"K2 launched {launches} times for {batches} batches")

    # The deterministic u ends at 1.0; the NeRF++ search stops at cdf[B-2],
    # so the guard meets it only where the last bin weighs under 1e-6.
    ray_o, ray_d = (x[:PP_BATCH] for x in requests["full_image"])
    with fp32_inference():
        level0 = render_rays_nerfpp(
            levels[:1], model_cfg, dataclasses.replace(render_cfg, perturb=False,
                                                       cascade_samples=PP_CASCADE[:1]),
            ray_o, ray_d, torch.full((PP_BATCH,), 1e-4, device=dev))[0]
        for k in ("fg_weights", "bg_weights"):
            w = level0[k][..., 1:-1] + 1e-6
            share = float((w[..., -1] / w.sum(-1) < 1e-6).float().mean())
            print(f"  share of rays whose last {k[:2]} bin weighs under 1e-6: {share:.4e}")
    return requests, outputs, launches


def phase_nerfpp_cpu_agreement(slice_, requests, outputs):
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.serve import make_nerfpp_serve_fn

    print("== phase 7: the card against the CPU port, NeRF++")
    model_cfg, render_cfg, levels, _ = slice_
    n = PP_CPU_RAYS
    name = f"{PP_PIXEL_REQUESTS[-1]}_pixels"
    ray_o, ray_d = (x[:n].cpu() for x in requests[name])
    cpu_levels = bridge.tree_to_torch(bridge.tree_to_numpy(levels), device="cpu")
    before = pdf_cuda.diff_launches
    cpu_out = make_nerfpp_serve_fn(cpu_levels, model_cfg, render_cfg)(
        ray_o, ray_d, torch.full((n,), 1e-4))
    require(pdf_cuda.diff_launches == before, "the CPU run launched the CUDA kernel")
    for k in ("rgb", "fg_depth", "bg_lambda"):
        err = np.abs(cpu_out[k].numpy() - outputs[name][k][:n])
        print(f"  {k} over {n} rays: median|err|={np.median(err):.3e} max|err|={err.max():.3e}")
        if k == "rgb":
            require(np.median(err) < 1e-5, f"card vs CPU rgb median error {np.median(err)}")
            require(err.max() < 1e-3, f"card vs CPU rgb max error {err.max()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scnerf_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print("== phase 1: card, versions, kernel build")
    print(f"  card: {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.build("sample_pdf")
    _build.load("sample_pdf")
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s")
    log = _build.BUILD_DIR / "sample_pdf.log"
    if log.exists():
        print("  " + log.read_text().strip().replace("\n", "\n  "))

    record = phase_kernels(dev)
    slice_ = make_slice(dev)
    requests, outputs, launches = phase_slice(dev, card, slice_)
    phase_cpu_agreement(slice_, requests, outputs)
    del slice_, requests, outputs

    pp_record = phase_k2(dev)
    pp_slice = make_nerfpp_slice(dev)
    pp_requests, pp_outputs, pp_launches = phase_nerfpp_slice(dev, card, pp_slice)
    phase_nerfpp_cpu_agreement(pp_slice, pp_requests, pp_outputs)

    print(json.dumps({"kernels": [{
        "name": "sample_pdf",
        "route": "cuda",
        "source": "scnerf_tpu_torch/csrc/sample_pdf.cu",
        "replaces": "scnerf_tpu/kernels/pdf_pallas.py:66",
        "launches": launches,
        **record,
    }, {
        "name": "sample_pdf_nerfpp",
        "route": "cuda",
        "source": "scnerf_tpu_torch/csrc/sample_pdf.cu",
        "replaces": "scnerf_tpu/kernels/pdf_pallas.py:194",
        "launches": pp_launches,
        **pp_record,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
