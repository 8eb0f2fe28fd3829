"""Drive the PyTorch port's NeRF and NeRF++ serving paths, its NeRF and
NeRF++ train steps and its NeRF training CLI once on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports neither JAX nor
the JAX package. Phases, each of which exits non-zero when it fails:

1. The card's name and power limit, the versions, and the kernels' build
   from ``scnerf_tpu_torch/csrc`` (timed; one ``nvcc`` per library, all
   started together): K3's and K4's ctypes libraries, and K1's and K2's
   operator library (``sample_pdf.cu`` with ``sample_pdf_op.cpp``, against
   torch's headers). Each kernel's host route (registered operator or
   ctypes) and the path of the library it loaded.
2. K1, the inverse-CDF CUDA kernel, against its plain PyTorch twin on the
   card at the serving shapes (8192 rays; 63, 62 and 64 bins; 64 samples;
   deterministic and random u): median |err| < 1e-6, under 0.1% of samples
   off by more than 1e-4 (boundary flips), every output within the bins
   (1e-5 slack). Time per call of both, from CUDA events around 50
   back-to-back calls (median of 5), under one ``inference_mode`` block as
   the serving path calls it; at the serving shape also K1 and
   ``torch.searchsorted`` on the same CDF rows and queries in turns, by
   events (11 turns) and host-only (as phase 8). On each input, the kernel's
   search counts against compare-and-count on its own CDF (the search of
   the kernel before the binary search): they must agree on every row whose
   CDF does not decrease; the shares of rows whose CDF decreases somewhere
   (the scan's rounding) and of samples whose count differs are printed.
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
   largest); the counts against compare-and-count as in phase 2; time per call of both, as in phase 2, inside one
   ``inference_mode`` block around the whole timed run, as
   ``render_chunked_nerfpp`` calls it (where the autograd function is not
   entered).
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
8. K4, the row-wise searchsorted CUDA kernel, on its own path (no render
   path calls it): the resamplers' shapes (8192 rows of 63 with 64 queries,
   4096 of 63 with 128), ragged shapes, and rows with repeated values and
   queries equal to row entries, both sides. The indices must equal the
   twin's exactly. Time per call of K4, of the twin and of
   ``torch.searchsorted`` (the one PyTorch call that computes the same
   function), the three timed in turns: by CUDA events (11 turns of 50
   calls), and host-only (``perf_counter_ns`` around 1,000 calls with no
   synchronisation, then one ``synchronize``; 3 turns).
9. K3, the fused encoding + NeRF MLP CUDA kernel, on its own path, at the
   points the NeRF serving path queries: the coarse (8192, 64) and fine
   (8192, 128) points and view directions of one 8192-ray batch of phase 3,
   recorded as the renderer hands them to ``query_field``, with phase 3's
   coarse and fine weights, and a ragged (1027, 33) cut of the fine points.
   Median |err| < 1e-5 and max < 2e-4 against the twin and against the raw
   output the serving path computed, both in full float32. Time per call of
   K3 (the wrapper's weight packing included), of the packing alone, of the
   twin and of ``query_field``; K3's bound is its 3xTF32 operations on the
   tensor cores (three TF32 passes at 495 TFLOP/s), printed beside the
   float32 CUDA-core bound, and its rate counts the useful float32
   operations (2 per multiply-add of the MLP).

10. The NeRF train step at full fern width, bench.py's workload: the fern
    model with seeded random weights and the learnable OpenGL camera of
    phase 3 (every ``*_noise`` and ``*_grid`` leaf trained),
    ``TrainConfig(5e-4, 250e3, near 2, far 6)``, Adam with weight decay 0.1,
    ``Curriculum()``, N_rand 1024, 64+64 samples, ``perturb=True``, batches
    drawn on the card by ``make_device_sampling_step`` from 8 seeded random
    756x1008 images. Every loss finite; at the first step every trainable
    leaf's gradient finite and nonzero but ``distortion_noise``'s (OpenGL
    reads no distortion); the ``*_init`` leaves bit-unchanged; K1 launched
    once per step. ms per step and train rays/s by CUDA events over 50 steps
    after 5 warm-up steps, peak memory, a ``torch.profiler`` breakdown of 3
    steps (kernel groups, device idle share, which fails below -2%: device
    time counted twice). K1 held to its plain twin, with phase 2's limits, on
    the inputs one train step hands it. Then 30 steps on one fixed
    batch must bring its loss below the first step's (with
    ``raw_noise_std=1.0`` if the seeded init has dead density).
11. bench.py's PRD step: the distortion-configured camera (focal 400,
    identity poses), 50 random matches, PRD every step: finite loss and
    gradients, ``prd_matches`` printed, ms per step and rays/s as phase 10.
12. One train step on the card against the CPU port at full width: 256 rays,
    the same params and injected randoms, without PRD, with PRD (16 matches
    projected through the camera, one padded), and with PRD on given rays
    (the camera then read by PRD alone): loss within relative 1e-5 and each
    leaf's gradient within relative L2 1e-4 or, where larger, the CPU's own
    spread: the CPU step again with each coarse sample moved by about one ulp
    of its depth (at multires 10 a few 1e-3 on the first layers and a few
    1e-2 on the camera) or, for the camera on given rays, with each keypoint
    and each entry of the initial intrinsics and poses moved by one ulp (a
    few 1e-4 to 1e-3). A lost gradient is off by 1. Controls: TF32 on in
    the whole step, in its backward only and in PRD's forward only must each
    break a limit. The grids' backward accumulates in an order the card does
    not fix: an L2 limit, not an elementwise one.
13. The NeRF++ train step at Tanks&Temples width, bench.py's
    ``_nerfpp_throughput`` workload: fg and bg MLPNets 8x256, multires 10/4,
    cascade 64,64, N_rand 2048, ``perturb=True``, bench.py's learnable
    OpenCV camera (546x980, focal 580, 12 images inside the unit sphere,
    multiplicative intrinsics noise) at its initial values, Adam as
    ``build_nerfpp_experiment`` builds it (decay 750e3, lr floor 1% of
    5e-4), ``Curriculum()``, batches drawn on the card by
    ``make_nerfpp_device_sampling_step`` from 12 seeded random images.
    Every loss finite; first-step gradients finite and nonzero but
    ``distortion_noise``'s; the ``*_init`` leaves bit-unchanged; K2
    launched twice a step, once with the CDF; no call waits for the device.
    ms a step and train rays/s by CUDA events over 20 steps after 3, peak
    memory, the profile (K2's forward in the sample_pdf group, its backward
    as the ``sample_pdf_diff_backward`` range), K2 held to its plain twin
    on the fg and bg inputs one step hands it (values, and the fg bins'
    gradient, with phase 5's limits) and its forward with the CDF and its
    backward timed by events on them; 30 steps on one fixed batch must
    bring the loss below the first step's.
14. bench.py's fisheye camera (radial k = (-0.1, 0.03), tied ray noise)
    with the distortion-aware PRD every step (``prd_undistort``) on 50
    matches: points along image 0's rays through the initial camera,
    projected into image 1 and taken back through the inverse warp. Finite
    loss and gradients, ``distortion_noise``'s gradient nonzero in the step
    and PRD's nonzero through the inverse-distortion lookup alone;
    ``prd_matches`` and ms a step printed.
15. One NeRF++ step on the card against the CPU port at full width, 256
    rays, the same params and injected randoms: without PRD, with the
    distortion-aware PRD on the fisheye camera, and with autoexpo and a
    mask. K2's outputs on the two devices may differ by a flip (phase 5's
    share holds them), and a ReLU whose pre-activation lies within rounding
    of 0 may take the other side (``KINK``); the CPU step takes the card's
    resampled depths and the card's side at such kinks, and every flipped
    pre-activation must lie within ``KINK`` of 0. Loss within relative
    1e-5; each leaf's gradient within relative L2 1e-4 or, where larger,
    the CPU's own spread, the largest change of its gradient over four CPU
    steps with one-ulp moves of the level-0 samples (two) and of the rays
    (two: the camera's initial intrinsics, poses and distortion). Control:
    TF32 on in the step must break a limit.

16. The training CLI at full fern width: ``scnerf_tpu_torch.cli.train.main``
    in-process with ``configs/llff/fern_ours.txt`` (NeRF 8x256, multires
    10/4, 64+64 samples, ``raw_noise_std`` 1, N_rand 1024 drawn from a
    ``PixelPool`` through the full learnable camera, weight decay 0.1, PRD
    one step in ten) on a seeded scene of fern's shape written into a
    temporary directory: 20 views of 378x504 with fern's hwf column, smooth
    seeded textures in ``images/`` and ``images_8/``, and ``matches.npz``
    projected from 200 seeded points through the ground-truth poses.
    ``--add_ie 0 --add_od 0 --add_prd 0 --i_print 10 --i_weights 30``: 60
    steps, then ``main`` again to 80, which must resume from step 60. Every
    ``metrics.jsonl`` row finite, the last logged loss below the first, PRD
    on every tenth step, ``prd_matches > 0`` on the first (the camera at its
    initial values; the counts of the others printed with how far the poses
    wandered), checkpoints at 30 and 60 and, after
    the resume, 80; each run's ``[eval]`` PSNR finite and SSIM in (0, 1); K1
    launched once a train step and once a chunk of the three test-view
    renders. Then, on the resumed experiment: ten loop steps (one with PRD)
    under ``torch.cuda.set_sync_debug_mode`` with no call that waits for
    the device; the loop against the same step functions on one ready device
    batch in turns (the gap is the host loop's own cost); ``train_loop`` with
    the evaluation hooks (test views, train and val PRD on injected test-view
    matches, the validation PNG, the camera log and its PNGs, read back).
    Printed: each step's ms by CUDA events, plain and PRD steps apart, the
    loop's ms a step and train rays/s, one test view's render time and rays/s,
    SSIM's time, the checkpoint's bytes and save and restore times, peak
    memory and the phase's seconds.
17. The card against the CPU port on the driver's evaluation, from the same
    weights on one test view: ``aligned_eval_extrinsic`` max |err| < 1e-5;
    the render's rgb on 1,024 seeded pixels (``render_pixels`` on the CPU)
    median |err| < 1e-5 and max < 1e-3; SSIM on the same images |diff| <
    1e-6; ``evaluate_prd_split`` within relative 1e-5 with the learned
    intrinsics moved by a few pixels on both devices (with the trained
    camera, at the ground truth, it reads float32's rounding, about 5e-7
    px^2: printed, not compared). Controls, printed and
    not conditions: SSIM as JAX computes it, the 2-D window by ``F.conv2d``,
    through cuDNN in float32 (the window computed on the CPU and on the
    card), without cuDNN, through cuDNN with TF32, and on the CPU.

Each serving path, each of K3's and K4's own paths and each train path run
with the kernels' launch counts set to 0 just before and read just after. The
line before the last is one JSON object with the kernels' numbers, each with
the least time the card could take for its work (``bound_ms``: bytes over
3.35 TB/s or operations over the peak of the unit the kernel uses, float32
at 67 TFLOP/s or, for K3, three TF32 passes at 495 TFLOP/s; the larger), K1's
and K2's with their launches on the train paths too (K2's with its shape,
error, times and bound on the NeRF++ train step's inputs), the train
metrics (the driver's of phases 16-17 among them, and K1's launches in phase
16 as ``driver_launches``) and the script's wall time; the line before it is
the card's name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
PP_FISHEYE_K = (-0.1, 0.03)  # bench.py's fisheye camera

SOURCES = ("searchsorted", "fused_mlp")  # K4 and K3, through ctypes
OPS_SOURCES = ("sample_pdf",)  # K1 and K2, registered operators
# K4: the resamplers' (rows, CDF entries, queries), ragged shapes, ties.
SEARCH_SHAPES = ((BATCH, 63, 64), (PP_BATCH, 63, 128))
SEARCH_RAGGED = ((1, 1, 1), (5, 17, 33), (1027, 200, 100))
K3_RAGGED = (1027, 33)
K3_TIMING_CALLS = 3  # a fine-shape call takes tens of milliseconds
HOST_CALLS = 1000  # phase 8's host-only timing
K4_TIMING_TURNS = 11

# H100 SXM, NVIDIA's data sheet: HBM bytes/s, float32 FLOP/s outside the
# tensor cores and dense TF32 FLOP/s on them, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def bound(n_bytes: float, n_ops: float, peak: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take: each input read and each output
    written once at the HBM rate, or the operations at ``peak``, the rate of
    the unit that does them, whichever is longer."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    from scnerf_tpu_torch.kernels import mlp_cuda, pdf_cuda, searchsorted_cuda

    pdf_cuda.launches = pdf_cuda.diff_launches = pdf_cuda.cdf_launches = 0
    mlp_cuda.launches = searchsorted_cuda.launches = 0


def launch_counts() -> dict:
    from scnerf_tpu_torch.kernels import mlp_cuda, pdf_cuda, searchsorted_cuda

    return {"K1": pdf_cuda.launches, "K2": pdf_cuda.diff_launches,
            "K2 with CDF": pdf_cuda.cdf_launches, "K3": mlp_cuda.launches,
            "K4": searchsorted_cuda.launches}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def in_turns(fns: dict, calls: int, repeats: int, *, host_only: bool = False) -> dict:
    """Milliseconds per call of each of ``fns``, their runs of ``calls``
    back-to-back calls taken in turns (a, b, c, a, b, c, ...) so that the
    host's noise falls on all alike; the median over ``repeats`` turns. By
    CUDA events around each run, or, with ``host_only``, by
    ``perf_counter_ns`` around the calls with no synchronisation (what the
    caller's thread spends to enqueue one) and one ``synchronize`` after the
    clock stops."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            if host_only:
                t0 = time.perf_counter_ns()
                for _ in range(calls):
                    fn()
                times[name].append((time.perf_counter_ns() - t0) / calls / 1e6)
                torch.cuda.synchronize()
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def per_call_ms(fn, calls: int = TIMING_CALLS, repeats: int = TIMING_REPEATS) -> float:
    """Milliseconds per call of ``fn`` alone, by :func:`in_turns`."""
    return in_turns({"fn": fn}, calls, repeats)["fn"]


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
            kernel = lambda: pdf_cuda.sample_pdf_core(bins, weights, u)  # noqa: E731
            with torch.inference_mode():  # as the serving path calls it
                ms = per_call_ms(kernel)
                plain_ms = per_call_ms(lambda: pdf_cuda.sample_pdf_plain(bins, weights, u))
            rows, samples = against_compare_and_count(bins, weights, u, "nerf",
                                                      f"K1 at {(n, b, s, det)}")
            print(f"  bins ({n},{b}) u ({n},{s}) det={det}: median|err|={med:.3e} "
                  f"max|err|={float(err.max()):.3e} share>1e-4={flips:.2e} "
                  f"in_bins={lo and hi} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; "
                  f"CDF decreasing in {rows:.3e} of rows, count off compare-and-count "
                  f"in {samples:.3e} of samples")
            require(med < 1e-6, f"K1 median error {med} at {(n, b, s, det)}")
            require(flips < 1e-3, f"K1 boundary-flip share {flips} at {(n, b, s, det)}")
            require(lo and hi, f"K1 output outside the bins at {(n, b, s, det)}")
            if (b, det) == (63, True):  # the serving path's shape
                # Reads bins, weights and u, writes the depths; per sample a
                # binary search over the B CDF entries and a lerp.
                record = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                              decreasing_cdf_rows=rows, off_compare_and_count=samples,
                              **bound(4 * (n * b + n * (b - 1) + 2 * n * s),
                                      n * s * (math.ceil(math.log2(b + 1)) + 6)
                                      + 3 * n * (b - 1)),
                              library_ms=None,
                              **beside_searchsorted("K1", kernel, bins, weights, u, "nerf"))
    return record


def against_compare_and_count(bins, weights, u, variant, what) -> tuple[float, float]:
    """The kernel's search counts against compare-and-count on the kernel's
    own CDF (the search PR 4's kernel did; the CDF and the lerp are the
    same, so a count that agrees gives the same depth, bit for bit). The
    binary search agrees wherever the row's CDF does not decrease; the
    shuffle scan can invert two neighbours by an ulp. Fails if a count
    differs on a row whose CDF does not decrease. Returns the share of rows
    whose CDF decreases somewhere and the share of samples whose count
    differs."""
    from scnerf_tpu_torch.kernels import pdf_cuda

    with torch.inference_mode():
        _, inds, cdf = pdf_cuda.sample_pdf_fwd(bins, weights, u, variant, with_cdf=True)
        searched = cdf[:, :-1] if variant == "nerfpp" else cdf
        count = (u[:, :, None] >= searched[:, None, :]).sum(-1, dtype=torch.int32)
        decreasing = (cdf.diff(dim=-1) < 0).any(-1)
        differs = inds != count
    require(not bool(differs[~decreasing].any()),
            f"{what}: a count differs from compare-and-count on a non-decreasing CDF")
    return float(decreasing.float().mean()), float(differs.float().mean())


def beside_searchsorted(label, kernel, bins, weights, u, variant) -> dict:
    """``kernel`` and ``torch.searchsorted`` of ``u`` in the rows of the CDF
    it searches, timed in turns under one ``inference_mode`` block: by CUDA
    events and host-only. The search is the part of the work one PyTorch
    call does; it is a yardstick of the host's cost per call, not of the
    function (``library_ms`` stays null)."""
    from scnerf_tpu_torch.sampling.pdf import inverse_cdf

    cdf = inverse_cdf(bins, weights, u, variant)[2]
    searched = cdf[:, :-1].contiguous() if variant == "nerfpp" else cdf
    fns = {"kernel": kernel,
           "searchsorted": lambda: torch.searchsorted(searched, u, right=True, out_int32=True)}
    with torch.inference_mode():
        by_events = in_turns(fns, TIMING_CALLS, K4_TIMING_TURNS)
        host = in_turns(fns, HOST_CALLS, 3, host_only=True)
    print(f"  {label} beside torch.searchsorted in turns: events ms {by_events['kernel']:.4f} "
          f"against {by_events['searchsorted']:.4f}; host-only ms per call over {HOST_CALLS}: "
          f"{host['kernel']:.4f} against {host['searchsorted']:.4f} "
          f"({host['kernel'] / host['searchsorted']:.2f}x)")
    return {"turns_ms": by_events["kernel"], "searchsorted_ms": by_events["searchsorted"],
            "host_ms": host["kernel"], "searchsorted_host_ms": host["searchsorted"]}


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

    reset_launches()
    outputs, rates = {}, {}
    for name, (rays_o, rays_d) in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[name] = request(rays_o, rays_d)  # ends in a device->host copy
        seconds = time.perf_counter() - t0
        rates[name] = rays_o.shape[0] / seconds
    counts = launch_counts()
    launches = counts["K1"]
    print(f"  launches on the NeRF path: {counts}")

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
            served = lambda: pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp")  # noqa: E731
            with torch.inference_mode():  # one block around the run, as the renderer's
                ms = per_call_ms(served)
                plain_ms = per_call_ms(
                    lambda: sample_pdf(None, bins, weights, s, u=u, variant="nerfpp"))
            rows, samples = against_compare_and_count(bins, weights, u, "nerfpp", what)
            print(f"  bins ({n},{b}) u ({n},{s}) det={det}: median|err|={med:.3e} "
                  f"max|err|={mx:.3e} share>1e-4={flips:.2e} grads off: {', '.join(off)}; "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; CDF decreasing in "
                  f"{rows:.3e} of rows, count off compare-and-count in {samples:.3e} of samples")
            if (b, det) == (63, True):  # the serving path's shape
                # As K1, and the int32 search counts written besides.
                record = dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                              decreasing_cdf_rows=rows, off_compare_and_count=samples,
                              **bound(4 * (n * b + n * (b - 1) + 3 * n * s),
                                      n * s * (math.ceil(math.log2(b)) + 6)
                                      + 3 * n * (b - 1)),
                              library_ms=None,
                              **beside_searchsorted("K2", served, bins, weights, u, "nerfpp"))
    for n, b, s in PP_RAGGED:
        bins, weights = resample_inputs(rng, n, b, dev)
        u = pdf_uniforms(gen, n, s, False, device=dev)
        got, want = kernel(bins, weights, u), plain(bins, weights, u)
        torch.cuda.synchronize()
        med, mx, _ = check_resample(got, want, bins, f"K2 at {(n, b, s)}")
        print(f"  ragged ({n},{b}) u ({n},{s}): median|err|={med:.3e} max|err|={mx:.3e}")
    return record


def make_nerfpp_slice(dev):
    from scnerf_tpu_torch.camera.model import get_extrinsics
    from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net
    from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig

    model_cfg = NerfPPConfig()  # 8x256, skip (4,), max_freq_log2 10/4
    render_cfg = NerfPPRenderConfig(cascade_samples=PP_CASCADE, chunk=PP_BATCH,
                                    pdf_impl="pallas_vjp")
    gen = torch.Generator().manual_seed(SEED + 3)
    levels = [init_nerfpp_net(model_cfg, PP_IMAGES, generator=gen, device=dev)
              for _ in PP_CASCADE]
    camera = nerfpp_camera(dev)
    # A camera as calibration leaves it: every learnable leaf non-zero (the
    # intrinsics noise is relative here: 1% of each of fx, fy, cx, cy).
    for name, scale in (("intrinsics_noise", 0.01), ("extrinsics_noise", 0.5),
                        ("ray_o_grid", 1.0), ("ray_d_grid", 1.0)):
        leaf = getattr(camera, name)
        setattr(camera, name, (torch.randn(leaf.shape, generator=gen) * scale).to(dev))
    centres = torch.linalg.vector_norm(get_extrinsics(camera)[:, :3, 3], dim=-1)
    require(float(centres.max()) < 1.0, f"a camera lies outside the unit sphere: {centres}")
    return model_cfg, render_cfg, levels, camera


def nerfpp_camera(device, *, fisheye: bool = False):
    """bench.py's NeRF++ camera at its initial values: OpenCV (pixel offset
    0.5) at 546x980, focal 580, 12 seeded poses inside the unit sphere,
    multiplicative intrinsics noise; with ``fisheye`` its distortion variant
    (radial k = (-0.1, 0.03), tied ray noise)."""
    from scnerf_tpu_torch.camera import CameraConfig, OPENCV, init_camera

    rng = np.random.RandomState(3)
    K = np.array([[PP_FOCAL, 0, PP_W / 2, 0], [0, PP_FOCAL, PP_H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    axis = rng.randn(PP_IMAGES, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    E = np.tile(np.eye(4), (PP_IMAGES, 1, 1))
    E[:, :3, :3] = rodrigues(axis, rng.rand(PP_IMAGES) * 0.3)
    E[:, :3, 3] = rng.randn(PP_IMAGES, 3) * 0.2
    cfg = CameraConfig(H=PP_H, W=PP_W, convention=OPENCV, pixel_offset=0.5,
                       multiplicative_noise=True, use_distortion=fisheye,
                       tied_ray_noise=fisheye)
    return init_camera(K, E, cfg, k=np.array(PP_FISHEYE_K) if fisheye else None, device=device)


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

    reset_launches()
    outputs, rates = {}, {}
    for name, (ray_o, ray_d) in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[name] = request(ray_o, ray_d)  # ends in a device->host copy
        seconds = time.perf_counter() - t0
        rates[name] = ray_o.shape[0] / seconds
    counts = launch_counts()
    launches = counts["K2"]
    print(f"  launches on the NeRF++ path: {counts}")

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


def sorted_rows(rng, rows, n, m, dev, *, ties=False):
    """Sorted rows in [0, 1] and queries; with ``ties``, runs of repeated
    values and queries equal to row entries half of the time."""
    a = rng.random((rows, n))
    if ties:
        a = np.round(a * 8) / 8
    a = np.sort(a, axis=-1).astype(np.float32)
    v = rng.random((rows, m)).astype(np.float32)
    if ties:
        picks = np.take_along_axis(a, rng.integers(0, n, (rows, m)), -1)
        v = np.where(rng.random((rows, m)) < 0.5, picks, v).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(v).to(dev)


def phase_k4(dev):
    from scnerf_tpu_torch.kernels import searchsorted_cuda
    from scnerf_tpu_torch.sampling.searchsorted import searchsorted

    print("== phase 8: K4 searchsorted kernel against its plain twin on the card")
    rng = np.random.default_rng(SEED + 5)
    cases = [((rows, n, m), False, *sorted_rows(rng, rows, n, m, dev))
             for rows, n, m in SEARCH_SHAPES + SEARCH_RAGGED]
    cases += [((rows, n, m), True, *sorted_rows(rng, rows, n, m, dev, ties=True))
              for rows, n, m in SEARCH_SHAPES]

    reset_launches()
    outs = [(shape, ties, a, v, side, searchsorted_cuda.searchsorted_cuda(a, v, side))
            for shape, ties, a, v in cases for side in ("left", "right")]
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts["K4"]
    print(f"  launches on K4's path: {counts}")
    require(launches == len(outs), f"K4 launched {launches} times for {len(outs)} calls")

    errs = {}
    for shape, ties, a, v, side, got in outs:
        want = searchsorted(a, v, side)
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        errs[shape] = max(errs.get(shape, 0), err)
        print(f"  a ({shape[0]},{shape[1]}) v ({shape[0]},{shape[2]}) ties={ties} side={side}: "
              f"max|index err|={err}")
        require(got.dtype == torch.int32 and torch.equal(got, want),
                f"K4 at {shape} ties={ties} side={side}: indices differ from the twin's")

    record = None
    for shape, ties, a, v in cases[:len(SEARCH_SHAPES)]:
        rows, n, m = shape
        # The resamplers count u >= cdf: the right side.
        fns = {"kernel": lambda: searchsorted_cuda.searchsorted_cuda(a, v, "right"),
               "plain": lambda: searchsorted(a, v, "right"),
               "library": lambda: torch.searchsorted(a, v, side="right", out_int32=True)}
        by_events = in_turns(fns, TIMING_CALLS, K4_TIMING_TURNS)
        ms, plain_ms, library_ms = by_events["kernel"], by_events["plain"], by_events["library"]
        host_only = in_turns(fns, HOST_CALLS, 3, host_only=True)
        host = {"host_ms": host_only["kernel"], "plain_host_ms": host_only["plain"],
                "library_host_ms": host_only["library"]}
        # Reads a and v, writes the indices; a binary search per query.
        bnd = bound(4 * (rows * n + 2 * rows * m), rows * m * math.ceil(math.log2(n + 1)))
        print(f"  a ({rows},{n}) v ({rows},{m}) right: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"torch.searchsorted_ms={library_ms:.4f} bound_ms={bnd['bound_ms']:.6f}; "
              f"host-only ms per call over {HOST_CALLS}: kernel {host['host_ms']:.4f}, "
              f"plain {host['plain_host_ms']:.4f}, torch.searchsorted {host['library_host_ms']:.4f}; "
              f"kernel/torch.searchsorted by events {ms / library_ms:.2f}x")
        if record is None:  # the NeRF resampler's shape
            record = dict(max_abs_err=float(errs[shape]), ms=ms, plain_ms=plain_ms, **bnd,
                          library_ms=library_ms, **host)
    return record, launches


def record_field_queries(dev, slice_, requests):
    """The coarse and fine field queries of one 8192-ray batch of phase 3's
    65,536-pixel request, as ``render_rays`` hands them to ``query_field``,
    each with the raw output the serving path computed."""
    from scnerf_tpu_torch.render import renderer
    from scnerf_tpu_torch.serve import make_nerf_serve_fn

    model_cfg, render_cfg, params, _, ndc = slice_
    rays_o, rays_d = (x[:BATCH] for x in requests["65536_pixels"])
    queries = []
    query_field = renderer.query_field

    def recording(p, cfg, pts, viewdirs=None):
        raw = query_field(p, cfg, pts, viewdirs)
        queries.append(dict(params=p, pts=pts, viewdirs=viewdirs, raw=raw))
        return raw

    renderer.query_field = recording
    try:
        make_nerf_serve_fn(params, model_cfg, render_cfg, ndc=ndc)(
            rays_o, rays_d, torch.zeros(BATCH, device=dev), torch.ones(BATCH, device=dev))
    finally:
        renderer.query_field = query_field
    shapes = [tuple(q["pts"].shape) for q in queries]
    require(shapes == [(BATCH, 64, 3), (BATCH, 128, 3)], f"recorded field queries {shapes}")
    return queries


def phase_k3(model_cfg, queries):
    from scnerf_tpu_torch.fields.nerf import query_field
    from scnerf_tpu_torch.kernels import mlp_cuda
    from scnerf_tpu_torch.serve import fp32_inference

    print("== phase 9: K3 fused encoding + NeRF MLP kernel at the NeRF serving path's points")
    print(f"  dynamic shared memory per block at multires {model_cfg.multires}/"
          f"{model_cfg.multires_views}: {mlp_cuda.shared_memory_bytes(model_cfg)} bytes")
    coarse, fine = queries
    n, s = K3_RAGGED
    cases = {"coarse": coarse, "fine": fine, "ragged": dict(
        params=fine["params"], pts=fine["pts"][:n, :s].contiguous(),
        viewdirs=fine["viewdirs"][:n].contiguous(), raw=fine["raw"][:n, :s])}

    reset_launches()
    with fp32_inference():
        outs = {name: mlp_cuda.fused_query_field(q["params"], model_cfg, q["pts"], q["viewdirs"])
                for name, q in cases.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts["K3"]
    print(f"  launches on K3's path: {counts}")
    require(launches == len(cases), f"K3 launched {launches} times for {len(cases)} calls")

    record = None
    for name, q in cases.items():
        args = (q["params"], model_cfg, q["pts"], q["viewdirs"])
        got = outs[name]
        require(got.shape == (*q["pts"].shape[:2], 4) and bool(torch.isfinite(got).all()),
                f"K3 {name}: shape {tuple(got.shape)} or values not finite")
        with fp32_inference():
            twin = mlp_cuda.fused_query_field_plain(*args)
        errs = {}
        for ref_name, ref in (("twin", twin), ("query_field", q["raw"])):
            err = (got - ref).abs()
            med, mx = float(err.median()), float(err.max())
            errs[ref_name] = (med, mx)
            print(f"  {name} pts {tuple(q['pts'].shape)} vs {ref_name}: median|err|={med:.3e} "
                  f"max|err|={mx:.3e}")
            require(med < 1e-5 and mx < 2e-4, f"K3 {name} vs {ref_name}: median {med}, max {mx}")
        if name == "ragged":
            continue

        def timed(fn):
            with fp32_inference():
                return per_call_ms(lambda: fn(*args), calls=K3_TIMING_CALLS, repeats=3)

        ms = timed(mlp_cuda.fused_query_field)
        pack_ms = per_call_ms(lambda: mlp_cuda.pack_weights(q["params"], model_cfg),
                              repeats=3)
        plain_ms = timed(mlp_cuda.fused_query_field_plain)
        query_field_ms = timed(query_field)
        weights = [x for layer in [*q["params"]["pts"], *(q["params"][h] for h in mlp_cuda.HEADS)]
                   for x in (layer["w"], layer["b"])]
        macs = sum(layer.numel() for layer in weights[::2])  # per point
        points = q["pts"].shape[0] * q["pts"].shape[1]
        flop = 2 * macs * points  # useful float32 operations (the sin/cos not counted)
        # Reads the points, view directions and weights once, writes the raw
        # outputs; the tensor cores do each multiply-add three times (3xTF32).
        n_bytes = 4 * (q["pts"].numel() + q["viewdirs"].numel()
                       + sum(x.numel() for x in weights) + got.numel())
        bnd = bound(n_bytes, 3 * flop, TF32_FLOP_PER_S)
        fp32_simt_ms = bound(n_bytes, flop)["bound_ms"]
        print(f"  {name}: {macs} MAC/point; kernel_ms={ms:.3f} (packing {pack_ms:.3f} of it) "
              f"plain_ms={plain_ms:.3f} query_field_ms={query_field_ms:.3f} "
              f"bound_ms={bnd['bound_ms']:.3f} (3xTF32 on the tensor cores; "
              f"{bnd['bound_ms'] / ms:.1%} of it) bound_fp32_simt_ms={fp32_simt_ms:.3f}; "
              f"kernel {flop / ms / 1e9:.2f} useful TFLOP/s; "
              f"query_field/kernel {query_field_ms / ms:.2f}x")
        if name == "fine":
            record = dict(max_abs_err=errs["twin"][1], median_abs_err=errs["twin"][0],
                          max_abs_err_query_field=errs["query_field"][1], ms=ms,
                          plain_ms=plain_ms, query_field_ms=query_field_ms, **bnd,
                          bound_unit="3xTF32 on tensor cores: 3 passes at 495 TFLOP/s",
                          bound_fp32_simt_ms=fp32_simt_ms, pack_ms=pack_ms,
                          useful_tflops=flop / ms / 1e9, library_ms=None)
    return record, launches


# The NeRF train step of bench.py's headline workload: N_rand 1024 at fern
# width, 64+64 samples, TrainConfig(5e-4, 250e3, near 2, far 6), Adam with
# weight decay 0.1 on the noise leaves, Curriculum().
TRAIN_RAYS = 1024
TRAIN_NEAR, TRAIN_FAR = 2.0, 6.0
TRAIN_WARMUP = 5
TRAIN_TIMED = 50
TRAIN_DESCENT = 30
TRAIN_PROFILED = 3
PRD_MATCHES = 50
CPU_TRAIN_RAYS = 256


class RecordingOptimizer:
    """An optimizer that keeps a copy of the first gradients it is handed
    and passes every call on to ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        if self.grads is None:
            self.grads = {k: None if g is None else g.detach().clone() for k, g in grads.items()}
        return self.inner.update(grads, state, params)


def train_tree(model_params: dict, camera, device) -> dict:
    """A train tree on ``device`` (trainable leaves requiring grad) from
    weights and a camera, through numpy, as the bridge carries JAX's."""
    from scnerf_tpu_torch import bridge

    return bridge.train_params_to_torch({
        "coarse": bridge.tree_to_numpy(model_params["coarse"]),
        "fine": bridge.tree_to_numpy(model_params["fine"]),
        "camera": {**bridge.camera_to_numpy(camera), "config": camera.config},
    }, device=device)


def train_setup(slice_, dev, *, with_prd=False, raw_noise_std=0.0, camera=None,
                curriculum=None):
    """(step function, its optimizer, a fresh train state) for bench.py's
    NeRF train workload on ``slice_``'s weights and camera."""
    from scnerf_tpu_torch.train.curriculum import Curriculum
    from scnerf_tpu_torch.train.optim import Optimizer
    from scnerf_tpu_torch.train.step import TrainConfig, create_train_state, make_train_step

    model_cfg, render_cfg, params, slice_camera, _ = slice_
    render_cfg = dataclasses.replace(render_cfg, perturb=True, raw_noise_std=raw_noise_std)
    train_cfg = TrainConfig(lr_init=5e-4, lr_decay_steps=250e3, weight_decay=0.1,
                            near=TRAIN_NEAR, far=TRAIN_FAR)
    optimizer = RecordingOptimizer(Optimizer.from_config(train_cfg))
    step = make_train_step(model_cfg, render_cfg, train_cfg, curriculum or Curriculum(),
                           optimizer, with_prd=with_prd)
    state = create_train_state(train_tree(params, camera or slice_camera, dev), optimizer)
    return step, optimizer, state


def time_steps(run_step, state, n: int):
    """(state, metrics of each step, ms per step by CUDA events around
    ``n`` back-to-back steps)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    start.record()
    for _ in range(n):
        state, m = run_step(state)
        metrics.append(m)
    end.record()
    end.synchronize()
    return state, metrics, start.elapsed_time(end) / n


KERNEL_GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("K1/K2 sample_pdf", ("sample_pdf",)),
    ("GEMMs", ("gemm", "gemv", "cutlass", "xmma", "cublas", "sm90_", "ampere_")),
    ("ReLU and its backward", ("threshold", "relu", "clamp_min")),
    ("concatenation and copies", ("cat", "copy")),
    ("sin/cos", ("sin", "cos")),
    ("reductions", ("reduce",)),
    ("sort", ("sort", "radix")),
    ("index, gather, scatter", ("index", "gather", "scatter")),
    ("other elementwise", ("elementwise", "vectorized", "unrolled", "foreach")),
)


PROFILE_RANGES = ("sample_pdf_diff_backward",)  # kernels/pdf_cuda.py's K2 backward


def profile_steps(run_step, state, n: int = TRAIN_PROFILED):
    """Device time of ``n`` steps by kernel group under ``torch.profiler``,
    and the share of the window's host-clock time in which the device ran
    no kernel. Returns (state, {group: ms per step}, idle share, top
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = run_step(state)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # A profiler range also shows as a device event spanning its kernels: it
    # is read below, apart from the kernels.
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in PROFILE_RANGES]
    require(bool(kernels), "the profiler saw no device time in the train step")
    # The host's calls into the CUDA runtime, a step: launches, copies and
    # waits for the device.
    runtime = {e.key: e.count / n for e in events
               if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("cuda")}
    ops = sorted(((e.count / n, e.key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")), reverse=True)[:10]
    groups = {}
    for key, _, ms in kernels:
        name = key.lower()
        group = next((g for g, subs in KERNEL_GROUPS if any(x in name for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms / n
    top = sorted(kernels, key=lambda k: -k[2])[:8]
    launches = sum(count for _, count, _ in kernels) / n
    # The device time of the kernels launched inside each profiler range
    # (K2's backward is PyTorch ops: no kernel of its own names it).
    ranges = {e.key: (e.count / n, e.device_time_total / 1e3 / n) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.key in PROFILE_RANGES}
    resamplers = [(key, count / n, ms / n) for key, count, ms in kernels
                  if "sample_pdf" in key.lower()]
    return state, dict(groups=groups, top=top, ops=ops, kernels_a_step=launches,
                       runtime_a_step=runtime, window_ms_a_step=window_ms / n, ranges=ranges,
                       resamplers=resamplers)


def sync_sites(run_step, state):
    """One step under ``torch.cuda.set_sync_debug_mode("warn")``: the
    Python lines whose operation waited for the device."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, _ = run_step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    return state, sorted({f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                          if "synchroniz" in str(w.message)})


def print_profile(profile, step_ms: float, n: int = TRAIN_PROFILED):
    """The profile, and the device's idle share of a step: 1 - device time a
    step over ``step_ms``, the step's time by CUDA events without the
    profiler (which slows the host severalfold). Returns the share."""
    groups, top = profile["groups"], profile["top"]
    busy = sum(groups.values())
    idle = 1.0 - busy / step_ms
    # More device time than the step takes would mean kernels counted twice.
    require(idle >= -0.02, f"profiled device time {busy:.3f} ms a step exceeds the "
                           f"{step_ms:.3f} ms step")
    print(f"  profile of {n} steps: {busy:.3f} ms device time a step, so the device idles "
          f"{idle:.2%} of a {step_ms:.3f} ms step ({profile['window_ms_a_step']:.3f} ms a step "
          f"by the host's clock under the profiler); {profile['kernels_a_step']:.0f} kernels a "
          f"step; CUDA runtime calls a step: "
          + ", ".join(f"{k} {v:g}" for k, v in sorted(profile["runtime_a_step"].items())))
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {group}: {ms:.3f} ms a step ({ms / busy:.2%})")
    for key, count, ms in profile["resamplers"]:
        print(f"    kernel {ms:.4f} ms a step x{count:g} ({ms / count:.5f} ms a launch): {key[:90]}")
    for key, (count, ms) in profile["ranges"].items():
        print(f"    range {key}: {ms:.3f} ms a step of device time ({ms / busy:.2%}), "
              f"x{count:g} a step (its kernels also counted in the groups above)")
    for key, count, ms in top:
        print(f"    kernel {ms / n:.3f} ms a step x{count / n:g}: {key[:90]}")
    print("    most frequent operators a step: "
          + ", ".join(f"{key} {count:g}" for count, key in profile["ops"]))
    return idle


def record_resample_inputs(run_step, state):
    """One step, with the (bins, weights, u) that ``render_rays`` hands K1
    and the depths K1 returned to it recorded."""
    from scnerf_tpu_torch.render import renderer

    calls = []
    core = renderer.sample_pdf_core

    def recording(bins, weights, u):
        out = core(bins, weights, u)
        calls.append((bins, weights, u, out))
        return out

    renderer.sample_pdf_core = recording
    try:
        state, _ = run_step(state)
    finally:
        renderer.sample_pdf_core = core
    require(len(calls) == 1, f"K1 called {len(calls)} times in one train step")
    return state, calls[0]


def phase_train(dev, card, slice_):
    """Phase 10: the NeRF train step at full fern width, batches drawn on
    the card."""
    from scnerf_tpu_torch.camera import FROZEN_LEAVES, pixels_to_rays
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.render.renderer import render_rays
    from scnerf_tpu_torch.serve import fp32
    from scnerf_tpu_torch.train.device_sampling import (
        make_device_sampling_step, sample_batch_on_device,
    )

    print("== phase 10: NeRF train step at full fern width on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    images = torch.rand((N_IMAGES, H, W, 3), generator=gen, device=dev)
    base, optimizer, state = train_setup(slice_, dev)
    step = make_device_sampling_step(base, images, TRAIN_RAYS)
    camera = state.params["camera"]
    frozen = {name: getattr(camera, name).clone() for name in FROZEN_LEAVES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    warm = []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, gen)
        warm.append(m)
    state, timed, ms = time_steps(lambda s: step(s, gen), state, TRAIN_TIMED)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    counts = launch_counts()
    launches = counts["K1"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches on the train path over {steps} steps: {counts}")
    require(launches == steps, f"K1 launched {launches} times in {steps} train steps")

    losses = torch.stack([m["loss"] for m in warm + timed])
    require(bool(torch.isfinite(losses).all()), "a train step's loss is not finite")
    first = {}
    for path, g in optimizer.grads.items():
        if g is None:
            first[path] = "none"
            continue
        require(bool(torch.isfinite(g).all()), f"first-step gradient of {path} not finite")
        first[path] = "nonzero" if bool(g.abs().any()) else "zero"
    zero = sorted(p for p, v in first.items() if v != "nonzero")
    print(f"  first step: {len(first)} trainable leaves, gradients finite; without a "
          f"nonzero gradient: {zero}")
    require(zero == ["camera/distortion_noise"],
            f"leaves without a nonzero first-step gradient: {zero}")
    for name, x in frozen.items():
        require(torch.equal(getattr(camera, name), x), f"the frozen {name} moved")
    rays_per_s = TRAIN_RAYS / ms * 1e3
    print(f"  {ms:.3f} ms a step by CUDA events over {TRAIN_TIMED} steps after "
          f"{TRAIN_WARMUP} warm-up steps: {rays_per_s:.1f} train rays/s ({card}); peak "
          f"memory {peak_gib:.3f} GiB; loss first {float(losses[0]):.5f} last "
          f"{float(losses[-1]):.5f}")

    state, profile = profile_steps(lambda s: step(s, gen), state)
    idle = print_profile(profile, ms)
    state, sites = sync_sites(lambda s: step(s, gen), state)
    print(f"  calls that wait for the device in one step: {sites or 'none'}")

    # K1 against its plain twin on the inputs the train step gives it:
    # jittered coarse bins, weights of the trained field, random u.
    state, (bins, weights, u, got) = record_resample_inputs(lambda s: step(s, gen), state)
    shapes = [tuple(x.shape) for x in (bins, weights, u)]
    n_coarse, n_fine = slice_[1].n_samples, slice_[1].n_importance
    require(shapes == [(TRAIN_RAYS, n_coarse - 1), (TRAIN_RAYS, n_coarse - 2),
                       (TRAIN_RAYS, n_fine)], f"K1's inputs in the train step: {shapes}")
    med, k1_err, flips = check_resample(got, pdf_cuda.sample_pdf_plain(bins, weights, u), bins,
                                        "K1 on the train step's inputs")
    print(f"  K1 on one train step's inputs {shapes}: median|err|={med:.3e} "
          f"max|err|={k1_err:.3e} share>1e-4={flips:.2e} against its plain twin")

    # Descent on one fixed batch. With dead density at the seeded init (acc
    # near 0 everywhere, so ReLU passes no density gradient) the check runs
    # with raw_noise_std = 1.0, as the LLFF reference trains.
    batch = sample_batch_on_device(images, gen, TRAIN_RAYS)
    fresh = train_setup(slice_, dev)[2]
    with torch.no_grad(), fp32():
        rays_o, rays_d = pixels_to_rays(fresh.params["camera"], batch["px"], batch["py"],
                                        image_idx=batch["img_idx"])
        viewdirs = rays_d / (torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
        acc = render_rays(fresh.params, slice_[0], slice_[1], rays_o, rays_d, viewdirs,
                          TRAIN_NEAR, TRAIN_FAR, gen)["acc"]
    acc_mean = float(acc.mean())
    noise = 1.0 if acc_mean < 1e-3 else 0.0
    base, _, fresh = train_setup(slice_, dev, raw_noise_std=noise)
    fixed = []
    for _ in range(TRAIN_DESCENT + 1):
        fresh, m = base(fresh, batch, gen)
        fixed.append(m["loss"])
    fixed = [float(x) for x in fixed]
    print(f"  fixed batch: acc mean at init {acc_mean:.3e}, raw_noise_std {noise}; loss "
          f"{fixed[0]:.5f} at the first step, {fixed[-1]:.5f} after {TRAIN_DESCENT} steps")
    require(fixed[-1] < fixed[0], f"the loss on a fixed batch did not fall: {fixed}")
    return dict(train_launches=launches, train_max_abs_err=k1_err, train_steps=steps, train_ms=ms,
                train_rays_per_s=rays_per_s, train_peak_gib=peak_gib,
                train_idle=idle, train_profile_ms=profile["groups"],
                train_kernels_a_step=profile["kernels_a_step"])


def phase_prd_train(dev, card, slice_):
    """Phase 11: bench.py's PRD step: the distortion-configured camera, 50
    matches, PRD every step."""
    from scnerf_tpu_torch.camera import CameraConfig, OPENGL, init_camera
    from scnerf_tpu_torch.train.curriculum import Curriculum

    print("== phase 11: NeRF train step with PRD every step on the card")
    cfg = CameraConfig(H=H, W=W, convention=OPENGL, use_distortion=True,
                       ray_o_noise_scale=1e-4, ray_d_noise_scale=1e-4,
                       extrinsics_noise_scale=1.0, distortion_noise_scale=1e-2)
    K = np.array([[400.0, 0, W / 2, 0], [0, 400.0, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    camera = init_camera(K, np.tile(np.eye(4), (N_IMAGES, 1, 1)), cfg, device=dev)
    step, optimizer, state = train_setup(slice_, dev, with_prd=True, camera=camera,
                                         curriculum=Curriculum(add_prd=0, i_ray_dist_loss=1))
    rng = np.random.RandomState(6)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "px": rng.randint(0, W, TRAIN_RAYS).astype(np.float32),
        "py": rng.randint(0, H, TRAIN_RAYS).astype(np.float32),
        "img_idx": rng.randint(0, N_IMAGES, TRAIN_RAYS),
        "target": rng.rand(TRAIN_RAYS, 3).astype(np.float32),
        "kps0": (rng.rand(PRD_MATCHES, 2) * [W, H]).astype(np.float32),
        "kps1": (rng.rand(PRD_MATCHES, 2) * [W, H]).astype(np.float32),
        "kp_mask": np.ones((PRD_MATCHES,), bool),
        "pair_idx": np.array([0, 1]),
    }.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    state, first = step(state, batch, gen)
    for path, g in optimizer.grads.items():
        require(g is None or bool(torch.isfinite(g).all()), f"PRD step: {path} gradient not finite")
    for _ in range(TRAIN_WARMUP - 1):
        state, _ = step(state, batch, gen)
    state, metrics, ms = time_steps(lambda s: step(s, batch, gen), state, TRAIN_TIMED)
    losses = torch.stack([first["loss"]] + [m["loss"] for m in metrics])
    require(bool(torch.isfinite(losses).all()), "a PRD step's loss is not finite")
    rays_per_s = TRAIN_RAYS / ms * 1e3
    print(f"  prd_matches {float(first['prd_matches']):g} of {PRD_MATCHES} (random keypoints, "
          f"as bench.py), prd {float(first['prd']):.5f}; gradients finite")
    print(f"  {ms:.3f} ms a step by CUDA events over {TRAIN_TIMED} steps after "
          f"{TRAIN_WARMUP} warm-up steps: {rays_per_s:.1f} train rays/s ({card})")
    state, profile = profile_steps(lambda s: step(s, batch, gen), state)
    idle = print_profile(profile, ms)
    state, sites = sync_sites(lambda s: step(s, batch, gen), state)
    print(f"  calls that wait for the device in one step: {sites or 'none'}")
    return dict(prd_train_ms=ms, prd_train_rays_per_s=rays_per_s, prd_train_idle=idle)


@contextlib.contextmanager
def fp32_cudnn():
    """TF32 off for matmuls and cuDNN, cuDNN on: a control of phase 17."""
    from scnerf_tpu_torch.serve import fp32

    with fp32(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


@contextlib.contextmanager
def fp32_no_cudnn():
    """TF32 off, cuDNN off (PyTorch's own convolution): a control of phase
    17."""
    from scnerf_tpu_torch.serve import fp32

    with fp32(), torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        yield


def conv2d_ssim(pred, target, flags, window_device) -> float:
    """SSIM as the JAX package computes it, the 2-D window (computed on
    ``window_device``) applied by ``F.conv2d`` under ``flags``: phase 17's
    controls for the port's separable float32 filter."""
    import torch.nn.functional as F

    x = torch.arange(11, dtype=torch.float32, device=window_device) - 5.0
    g = torch.exp(-0.5 * (x / 1.5) ** 2)
    g = g / torch.sum(g)
    window = torch.outer(g, g).to(pred.device)[None, None]

    def filt(img):
        return F.conv2d(img.permute(2, 0, 1)[:, None], window)[:, 0].permute(1, 2, 0)

    with flags():
        mu_x, mu_y = filt(pred), filt(target)
        sxx = torch.clamp(filt(pred * pred) - mu_x * mu_x, min=0.0)
        syy = torch.clamp(filt(target * target) - mu_y * mu_y, min=0.0)
        sxy = filt(pred * target) - mu_x * mu_y
        c1, c2 = 0.01**2, 0.03**2
        num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
        den = (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2)
        return float(torch.mean(num / den))


@contextlib.contextmanager
def tf32_on():
    """TF32 on for matmuls and cuDNN in the block, the flags restored after:
    phase 12's controls, and one of phase 17's."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rel_l2(got, want) -> float:
    """Relative L2 error of ``got`` against ``want`` (``|got|`` if ``want``
    is zero: a lost gradient reads 1)."""
    norm = float(want.norm())
    return float((got - want).norm()) / norm if norm > 0 else float(got.norm())


def over_limits(m, g, cpu_m, cpu_g, limits):
    """A card step's metrics and gradients against the CPU's: (relative loss
    error, rows (error / limit, path, error, limit), the worst first)."""
    rel_loss = abs(m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    rows = []
    for path, g_cpu in cpu_g.items():
        if g_cpu is None or g[path] is None:
            require(g_cpu is None and g[path] is None, f"{path}: a gradient on one side only")
            continue
        rel = rel_l2(g[path], g_cpu)
        rows.append((rel / limits[path], path, rel, limits[path]))
    return rel_loss, sorted(rows, reverse=True)


def one_ulp_moves(rng, x: np.ndarray) -> np.ndarray:
    """``x`` with each entry moved by one ulp, up or down at random."""
    return (x + np.where(rng.random(x.shape) < 0.5, -1.0, 1.0) * np.spacing(x)).astype(x.dtype)


def phase_train_cpu_agreement(dev, slice_):
    """Phase 12: one train step on the card against the CPU port, the same
    params and injected randoms: without PRD, with PRD, and with PRD on
    given rays; and the controls with TF32 on."""
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.camera import get_extrinsics, get_intrinsic, pixels_to_rays
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.train.curriculum import Curriculum

    print("== phase 12: one train step on the card against the CPU port")
    model_cfg, render_cfg, params, camera, _ = slice_
    n, s, si = CPU_TRAIN_RAYS, render_cfg.n_samples, render_cfg.n_importance
    rng = np.random.default_rng(SEED + 12)
    batch = {
        "px": rng.integers(0, W, n).astype(np.float32),
        "py": rng.integers(0, H, n).astype(np.float32),
        "img_idx": rng.integers(0, N_IMAGES, n),
        "target": rng.random((n, 3)).astype(np.float32),
        "rands": {"t": rng.random((n, s)), "noise0": rng.normal(size=(n, s)),
                  "noise1": rng.normal(size=(n, s + si)), "u": rng.random((n, si))},
    }
    batch["rands"] = {k: v.astype(np.float32) for k, v in batch["rands"].items()}
    # Matches between images 0 and 1: points 3-5 units along image 0's rays,
    # projected into image 1 through the same camera (OpenGL), half a pixel
    # of noise; the last one padded.
    cpu_camera = train_tree(params, camera, "cpu")["camera"]
    m = 16
    kps0 = np.stack([rng.uniform(0, W, m), rng.uniform(0, H, m)], -1).astype(np.float32)
    with torch.no_grad():
        o, d = pixels_to_rays(cpu_camera, torch.from_numpy(kps0[:, 0]),
                              torch.from_numpy(kps0[:, 1]), image_idx=0)
        pts = o + d * torch.from_numpy(rng.uniform(3.0, 5.0, (m, 1)).astype(np.float32))
        w2c = torch.linalg.inv(get_extrinsics(cpu_camera)[1])
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        K = get_intrinsic(cpu_camera)
        kps1 = torch.stack([K[0, 2] - K[0, 0] * cam[:, 0] / cam[:, 2],
                            K[1, 2] + K[1, 1] * cam[:, 1] / cam[:, 2]], -1).numpy()
    mask = np.ones(m, bool)
    mask[-1] = False
    prd_batch = {**batch, "kps0": kps0, "kps1": (kps1 + rng.normal(size=(m, 2)) * 0.5)
                 .astype(np.float32), "kp_mask": mask, "pair_idx": np.array([0, 1])}

    # The rays given, the camera read by PRD alone: its gradient then comes
    # from PRD, which reads no sample depths, and its limit from PRD's own
    # spread, apart from the photometric term's.
    with torch.no_grad():
        rays_o, rays_d = pixels_to_rays(cpu_camera, torch.from_numpy(batch["px"]),
                                        torch.from_numpy(batch["py"]),
                                        image_idx=torch.from_numpy(batch["img_idx"]))
    rays_batch = {k: v for k, v in prd_batch.items() if k not in ("px", "py", "img_idx")}
    rays_batch.update(rays_o=rays_o.numpy(), rays_d=rays_d.numpy())
    cases = {"without PRD": batch, "with PRD": prd_batch,
             "with PRD, rays given": rays_batch}

    def one_step(device, b, tf32=None, camera_=None):
        """The metrics and gradients (on the CPU) of one step on ``device``;
        ``tf32`` turns TF32 on there, as a control: in the whole "step", in
        its "backward" only, or in the forward of "PRD" only."""
        from scnerf_tpu_torch.train import step as step_module

        step, optimizer, state = train_setup(
            slice_, device, with_prd="kps0" in b, camera=camera_,
            curriculum=Curriculum(add_prd=0, i_ray_dist_loss=1))
        before = pdf_cuda.launches
        fp32, grad, prd = step_module.fp32, torch.autograd.grad, step_module.prd_loss

        def under_tf32(fn):
            def call(*args, **kwargs):
                with tf32_on():
                    return fn(*args, **kwargs)
            return call

        if tf32 == "step":
            step_module.fp32 = tf32_on
        elif tf32 == "backward":
            torch.autograd.grad = under_tf32(grad)
        elif tf32 == "PRD":
            step_module.prd_loss = under_tf32(prd)
        try:
            _, metrics = step(state, to_device(b, device))
        finally:
            step_module.fp32, torch.autograd.grad, step_module.prd_loss = fp32, grad, prd
        launched = pdf_cuda.launches - before
        require(launched == (1 if device.type == "cuda" else 0),
                f"K1 launched {launched} times in one {device.type} train step")
        return ({k: float(v) for k, v in metrics.items()},
                {k: None if g is None else g.cpu() for k, g in optimizer.grads.items()})

    depth = TRAIN_NEAR + (TRAIN_FAR - TRAIN_NEAR) * np.arange(s) / (s - 1)
    dt = np.spacing(depth.astype(np.float32)) / ((TRAIN_FAR - TRAIN_NEAR) / (s - 1))

    def nudged_step(b, kind):
        """The CPU gradients of one step with one-ulp random moves of the
        coarse samples' depths ("samples"), or of the keypoints and the
        camera's initial intrinsics and poses ("PRD")."""
        ups = lambda x: np.where(rng.random(x.shape) < 0.5, -1.0, 1.0)  # noqa: E731
        if kind == "samples":
            t = b["rands"]["t"]
            nudged = {**b, "rands": {**b["rands"], "t": np.clip(
                t + ups(t) * dt, 0.0, 1.0).astype(np.float32)}}
            return one_step(torch.device("cpu"), nudged)[1]
        nudged = {**b, **{k: one_ulp_moves(rng, b[k]) for k in ("kps0", "kps1")}}
        leaves = bridge.camera_to_numpy(camera)
        for k in ("intrinsics_init", "extrinsics_init"):
            leaves[k] = one_ulp_moves(rng, leaves[k])
        nudged_camera = bridge.camera_from_numpy({**leaves, "config": camera.config},
                                                 device="cpu")
        return one_step(torch.device("cpu"), nudged, camera_=nudged_camera)[1]

    for case, b in cases.items():
        card_m, card_g = one_step(dev, b)
        cpu_m, cpu_g = one_step(torch.device("cpu"), b)
        # float32's own spread: the larger change of each leaf's CPU gradient
        # over two nudged CPU steps, so that one lucky draw does not set the
        # limit. Photometric: each coarse sample moved by about one ulp of
        # its depth, up or down at random, as the two devices' roundings move
        # some of them; at multires 10 sin(2^9 x) turns an ulp of x into
        # ~1e-4 of its value, and the first layers' and the camera's
        # gradients sum such terms with cancellation. PRD, for the camera
        # when the rays are given: each keypoint coordinate and each entry of
        # the camera's initial intrinsics and poses moved by one ulp; the
        # triangulation of rays a small baseline apart amplifies it.
        rays_given = "rays_o" in b
        kinds = ("samples", "PRD") if rays_given else ("samples",)
        spread = {kind: [nudged_step(b, kind) for _ in range(2)] for kind in kinds}
        limits = {}
        for path, g_cpu in cpu_g.items():
            if g_cpu is not None:
                kind = "PRD" if rays_given and path.startswith("camera/") else "samples"
                limits[path] = max(1e-4, max(rel_l2(g[path], g_cpu) for g in spread[kind]))
        rel_loss, rows = over_limits(card_m, card_g, cpu_m, cpu_g, limits)
        extra = (f"; prd {card_m['prd']:.6f} / {cpu_m['prd']:.6f}, prd_matches "
                 f"{card_m['prd_matches']:g} / {cpu_m['prd_matches']:g}") if "prd" in cpu_m else ""
        held = sum(limit == 1e-4 for limit in limits.values())
        print(f"  {case}, {n} rays: loss {card_m['loss']:.7f} card, {cpu_m['loss']:.7f} CPU "
              f"(relative {rel_loss:.3e}){extra}; {len(rows)} leaves, {held} held at 1e-4, "
              f"the rest at the CPU's spread under one-ulp moves of the "
              + ("samples (the camera's: of PRD's inputs)" if rays_given else "samples"))
        shown = rows[:6] + [r for r in rows[6:] if r[1].startswith("camera/")]
        for ratio, path, rel, limit in shown:
            print(f"    {path}: card vs CPU {rel:.3e}, limit {limit:.3e} ({ratio:.2f} of it)")
        for ratio, path, rel, limit in rows:
            require(ratio <= 1.0, f"{case}: card vs CPU gradient of {path}: relative L2 "
                                  f"{rel:.3e} over its limit {limit:.3e}")
        require(rel_loss <= 1e-5, f"{case}: card vs CPU train loss relative error {rel_loss}")
        if rays_given:
            require(card_m["prd_matches"] > 0, "no PRD match in the rays-given case")
        # Controls: TF32 on in the whole step, in its backward only, and in
        # PRD's forward only. The same limits must catch each that moves
        # anything.
        for tf32 in ("step", "backward", "PRD") if "kps0" in b else ("step", "backward"):
            m, g = one_step(dev, b, tf32)
            rel_loss, rows = over_limits(m, g, cpu_m, cpu_g, limits)
            failed = [f"{path} {ratio:.2f}x" for ratio, path, _, _ in rows if ratio > 1.0]
            moved = max(rel_l2(g[p], card_g[p]) for p in limits)
            print(f"  control, TF32 on in the {tf32}: loss relative {rel_loss:.3e}"
                  f"{' (over 1e-5)' if rel_loss > 1e-5 else ''}; gradients moved up to "
                  f"{moved:.3e} from the float32 card step; {len(failed)} leaves over their "
                  f"limits: {', '.join(failed[:8]) or 'none'}")
            if rays_given:
                print("    the camera's (PRD's) leaves against their limits: " + ", ".join(
                    f"{path} {ratio:.2f}x" for ratio, path, _, _ in rows
                    if path.startswith("camera/")))
            require(moved == 0.0 or rel_loss > 1e-5 or bool(failed),
                    f"{case}: TF32 on in the {tf32} passes the limits")


# NeRF++ training, bench.py's _nerfpp_throughput (the Tanks&Temples
# workload): fg and bg MLPNets 8x256, multires 10/4, cascade 64,64, N_rand
# 2048, perturb, bench.py's learnable OpenCV camera at its initial values,
# Adam as build_nerfpp_experiment builds it (decay 750e3, lr floor 1% of
# 5e-4), Curriculum().
PP_TRAIN_RAYS = 2048
PP_TRAIN_CASCADE = (64, 64)
PP_TRAIN_WARMUP = 3
PP_TRAIN_TIMED = 20
PP_PRD_MATCHES = 50
PP_CPU_TRAIN_RAYS = 256


def nerfpp_train_setup(device, *, fisheye=False, autoexpo=False, with_prd=False,
                       curriculum=None, camera=None):
    """(step function, its recording optimizer, a fresh train state) for the
    NeRF++ train workload on ``device``: seeded weights, made on the CPU and
    copied through numpy as the bridge carries JAX's, so that every device
    starts from the same bits; ``camera`` (on the CPU) in place of the
    workload's initial one."""
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net
    from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig
    from scnerf_tpu_torch.train.curriculum import Curriculum
    from scnerf_tpu_torch.train.nerfpp_step import NerfPPTrainConfig, make_nerfpp_train_step
    from scnerf_tpu_torch.train.optim import Optimizer
    from scnerf_tpu_torch.train.step import create_train_state

    model_cfg = NerfPPConfig()  # 8x256, skip (4,), max_freq_log2 10/4
    render_cfg = NerfPPRenderConfig(cascade_samples=PP_TRAIN_CASCADE, perturb=True)
    train_cfg = NerfPPTrainConfig(lr_init=5e-4, lr_decay_steps=750e3, autoexpo=autoexpo,
                                  prd_undistort=fisheye)
    gen = torch.Generator().manual_seed(SEED + 13)
    levels = [init_nerfpp_net(model_cfg, PP_IMAGES, autoexpo=autoexpo, generator=gen,
                              device="cpu") for _ in PP_TRAIN_CASCADE]
    camera = camera or nerfpp_camera("cpu", fisheye=fisheye)
    tree = bridge.train_params_to_torch({
        "levels": bridge.tree_to_numpy(levels),
        "camera": {**bridge.camera_to_numpy(camera), "config": camera.config},
    }, device=device)
    optimizer = RecordingOptimizer(Optimizer.from_config(train_cfg,
                                                         lr_floor=0.01 * train_cfg.lr_init))
    step = make_nerfpp_train_step(model_cfg, render_cfg, train_cfg, curriculum or Curriculum(),
                                  optimizer, with_prd=with_prd)
    return step, optimizer, create_train_state(tree, optimizer)


def nerfpp_matches(rng, camera, n: int):
    """``n`` matches between images 0 and 1 of the initial ``camera`` (on
    the CPU): integer pixels of image 0, their rays through the camera (the
    distortion warp included), points 1.5 to 4 units along them, projected
    into image 1 by the pinhole and, with distortion, taken back through the
    inverse of the warp (the keypoint's ray passes through the warped pixel
    ``kp + 0.5``); a third of a pixel of noise. Only points in front of
    image 1 and inside it are kept."""
    from scnerf_tpu_torch.camera import get_distortion, get_extrinsics, get_intrinsic
    from scnerf_tpu_torch.camera import pixels_to_rays

    m = 20 * n
    px = rng.integers(0, PP_W, m).astype(np.float32)
    py = rng.integers(0, PP_H, m).astype(np.float32)
    with torch.no_grad():
        o, d = pixels_to_rays(camera, torch.from_numpy(px), torch.from_numpy(py), image_idx=0)
        pts = (o + d * torch.from_numpy(rng.uniform(1.5, 4.0, (m, 1)).astype(np.float32)))
        w2c = torch.linalg.inv(get_extrinsics(camera)[1])
        cam = (pts @ w2c[:3, :3].T + w2c[:3, 3]).double().numpy()
        K = get_intrinsic(camera).double().numpy()
        k = get_distortion(camera).double().numpy()
    uv = np.stack([K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2],
                   K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]], -1)
    if camera.config.use_distortion:
        for axis, L in ((0, PP_W), (1, PP_H)):
            grid = np.linspace(-L, 2 * L, 200001)
            c = (grid - L / 2) / (L / 2)
            uv[:, axis] = np.interp(uv[:, axis], (1 + k[0] * c**2 + k[1] * c**4)
                                    * (grid - L / 2) + L / 2, grid)
    kps1 = uv - 0.5 + rng.normal(size=uv.shape) * 0.3
    keep = (cam[:, 2] > 0.1) & (kps1 >= 0).all(-1) & (kps1[:, 0] < PP_W) & (kps1[:, 1] < PP_H)
    require(keep.sum() >= n, f"only {keep.sum()} of {m} points project into image 1")
    kps0 = np.stack([px, py], -1)[keep][:n].astype(np.float32)
    return {"kps0": kps0, "kps1": kps1[keep][:n].astype(np.float32),
            "kp_mask": np.ones(n, bool), "pair_idx": np.array([0, 1])}


def to_device(batch, device):
    """Nested dicts/lists/tuples of numpy values -> tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    return torch.from_numpy(np.asarray(batch)).to(device)


@contextlib.contextmanager
def recorded_resamples(calls: list, values: list | None = None):
    """Within the block, each K2 call of the NeRF++ renderer is appended to
    ``calls`` as (bins, weights, u, depths). With ``values``, the i-th call
    hands the renderer ``values[i]`` in place of its depths (its gradient
    stays the call's own)."""
    from scnerf_tpu_torch.render import nerfpp_renderer

    diff = nerfpp_renderer.sample_pdf_diff

    def recording(bins, weights, u, variant="nerfpp"):
        out = diff(bins, weights, u, variant)
        calls.append((bins, weights, u, out))
        if values is not None:
            out = out + (values[len(calls) - 1].to(out.device) - out).detach()
        return out

    nerfpp_renderer.sample_pdf_diff = recording
    try:
        yield
    finally:
        nerfpp_renderer.sample_pdf_diff = diff


# |pre-activation| under which the card's and the CPU's float32 roundings may
# put a ReLU (or the sigma head's abs) on opposite sides of its kink. At
# multires 10, sin(2^9 x) turns an ulp of a point into a few 1e-5 of a
# feature, and a layer sums 256 of them: the two devices' pre-activations
# may differ by up to about 1e-4, while most lie between 1e-2 and 1.
KINK = 1e-3


@contextlib.contextmanager
def kink_sides(seen: list, card: list | None = None):
    """Within the block, each dense layer of the NeRF++ field appends to
    ``seen`` its output entries within ``KINK`` of 0, as (flat indices,
    values) on the CPU. With ``card`` (the card's ``seen`` of the same step,
    call for call), an entry that the card put on the other side of 0 takes
    the card's value (its gradient stays this step's own), so that both
    devices' ReLUs and abs take the same side; ``seen`` then gets (flat
    indices, the CPU's values, the card's values) of those entries."""
    from scnerf_tpu_torch.fields import nerfpp

    dense = nerfpp.dense

    def sided(params, x):
        y = dense(params, x)
        flat = y.detach().reshape(-1)
        if card is None:
            idx = torch.nonzero(flat.abs() < KINK).flatten()
            seen.append((idx.cpu(), flat[idx].cpu()))
            return y
        idx, theirs = card[len(seen)]
        mine = flat[idx]
        flip = (mine > 0) != (theirs > 0)
        seen.append((idx[flip], mine[flip], theirs[flip]))
        delta = torch.zeros_like(flat)
        delta[idx[flip]] = theirs[flip] - mine[flip]
        return y + delta.reshape(y.shape)

    nerfpp.dense = sided
    try:
        yield
    finally:
        nerfpp.dense = dense


def k2_on_train_inputs(dev, calls):
    """K2 against its plain twin on the (bins, weights, u) one NeRF++ train
    step hands it, with phase 5's limits: the fg call (bins requiring grad,
    CDF saved) and the bg call (forward only); values, and the fg call's
    gradients into its bins under a random cotangent. Then K2's forward and
    its backward (``sample_pdf_diff_backward``, PyTorch ops) timed by events
    on the fg inputs. Returns K2's train record."""
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.sampling.pdf import sample_pdf

    require(len(calls) == 2, f"K2 called {len(calls)} times in one NeRF++ train step")
    require(calls[0][0].requires_grad and not calls[1][0].requires_grad,
            "the fg bins should require grad and the bg bins not")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    record = {}
    for name, (bins, weights, u, out) in zip(("fg", "bg"), calls):
        n, b = bins.shape
        s = u.shape[1]
        bins_d = bins.detach()
        with torch.no_grad():
            plain = sample_pdf(None, bins_d, weights, s, u=u, variant="nerfpp")
        med, mx, flips = check_resample(out.detach(), plain, bins_d, f"K2 {name} train step")
        rows, samples = against_compare_and_count(bins_d, weights, u, "nerfpp",
                                                  f"K2 {name} train step")
        line = (f"  K2 {name} on one train step's inputs ({n},{b}) ({n},{b - 1}) ({n},{s}): "
                f"median|err|={med:.3e} max|err|={mx:.3e} share>1e-4={flips:.2e}; CDF "
                f"decreasing in {rows:.3e} of rows, count off compare-and-count in "
                f"{samples:.3e} of samples")
        if name == "fg":
            cot = torch.randn(u.shape, generator=gen, device=dev)
            leaf = bins_d.clone().requires_grad_()
            gk, = torch.autograd.grad(pdf_cuda.sample_pdf_diff(leaf, weights, u) * cot, leaf,
                                      torch.ones_like(u))
            gp, = torch.autograd.grad(sample_pdf(None, leaf, weights, s, u=u, variant="nerfpp")
                                      * cot, leaf, torch.ones_like(u))
            frac = float(((gk - gp).abs() / (gp.abs().max() + 1e-8) > 1e-4).float().mean())
            require(frac < 2e-3, f"K2 fg train step: gradient into bins, {frac} of entries off")
            with torch.no_grad():
                _, inds, cdf = pdf_cuda.sample_pdf_fwd(bins_d, weights, u, with_cdf=True)
                fwd_ms = per_call_ms(lambda: pdf_cuda.sample_pdf_fwd(bins_d, weights, u,
                                                                     with_cdf=True))
                plain_ms = per_call_ms(lambda: sample_pdf(None, bins_d, weights, s, u=u,
                                                          variant="nerfpp"))
                bwd_ms = per_call_ms(lambda: pdf_cuda.sample_pdf_diff_backward(
                    cot, bins_d, weights, u, inds, cdf, "nerfpp"))
            # The forward with the CDF: reads bins, weights and u, writes the
            # depths, the counts and the CDF.
            bnd = bound(4 * (n * b + n * (b - 1) + 3 * n * s + n * b),
                        n * s * (math.ceil(math.log2(b)) + 6) + 3 * n * (b - 1))
            line += (f"; gradient into bins off in {frac:.2e} of entries; forward with CDF "
                     f"{fwd_ms:.4f} ms by events (plain twin {plain_ms:.4f}, bound "
                     f"{bnd['bound_ms']:.5f}), backward {bwd_ms:.4f} ms")
            record = dict(train_shape=[n, b, s], train_max_abs_err=mx, train_ms=fwd_ms,
                          train_plain_ms=plain_ms, train_bound_ms=bnd["bound_ms"],
                          train_backward_ms=bwd_ms, train_grad_share_off=frac)
        print(line)
    return record


def phase_nerfpp_train(dev, card):
    """Phase 13: the NeRF++ train step at Tanks&Temples width, batches drawn
    on the card."""
    from scnerf_tpu_torch.camera import FROZEN_LEAVES
    from scnerf_tpu_torch.train.device_sampling import (
        make_nerfpp_device_sampling_step, sample_nerfpp_batch,
    )

    print("== phase 13: NeRF++ train step at Tanks&Temples width on the card")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    images = torch.rand((PP_IMAGES, PP_H, PP_W, 3), generator=gen, device=dev)
    base, optimizer, state = nerfpp_train_setup(dev)
    step = make_nerfpp_device_sampling_step(base, images, PP_TRAIN_RAYS)
    camera = state.params["camera"]
    frozen = {name: getattr(camera, name).clone() for name in FROZEN_LEAVES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    warm = []
    for _ in range(PP_TRAIN_WARMUP):
        state, m = step(state, gen)
        warm.append(m)
    state, timed, ms = time_steps(lambda s: step(s, gen), state, PP_TRAIN_TIMED)
    steps = PP_TRAIN_WARMUP + PP_TRAIN_TIMED
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches on the NeRF++ train path over {steps} steps: {counts}")
    require(counts["K2"] == 2 * steps and counts["K2 with CDF"] == steps,
            f"K2 launched {counts['K2']} times ({counts['K2 with CDF']} with the CDF) in "
            f"{steps} steps; 2 a step, 1 of them with the CDF, expected")

    losses = torch.stack([m["loss"] for m in warm + timed])
    require(bool(torch.isfinite(losses).all()), "a NeRF++ train step's loss is not finite")
    first = {}
    for path, g in optimizer.grads.items():
        if g is None:
            first[path] = "none"
            continue
        require(bool(torch.isfinite(g).all()), f"first-step gradient of {path} not finite")
        first[path] = "nonzero" if bool(g.abs().any()) else "zero"
    zero = sorted(p for p, v in first.items() if v != "nonzero")
    print(f"  first step: {len(first)} trainable leaves, gradients finite; without a "
          f"nonzero gradient: {zero}")
    require(zero == ["camera/distortion_noise"],
            f"leaves without a nonzero first-step gradient: {zero}")
    for name, x in frozen.items():
        require(torch.equal(getattr(camera, name), x), f"the frozen {name} moved")
    rays_per_s = PP_TRAIN_RAYS / ms * 1e3
    print(f"  {ms:.3f} ms a step by CUDA events over {PP_TRAIN_TIMED} steps after "
          f"{PP_TRAIN_WARMUP} warm-up steps: {rays_per_s:.1f} train rays/s ({card}); peak "
          f"memory {peak_gib:.3f} GiB; loss first {float(losses[0]):.5f} last "
          f"{float(losses[-1]):.5f}")

    state, profile = profile_steps(lambda s: step(s, gen), state)
    idle = print_profile(profile, ms)
    backward = profile["ranges"].get("sample_pdf_diff_backward", (0.0, 0.0))
    if backward[0] == 0.0:
        print("  the profiler saw no sample_pdf_diff_backward range: K2's backward is timed "
              "by events below")
    state, sites = sync_sites(lambda s: step(s, gen), state)
    print(f"  calls that wait for the device in one step: {sites or 'none'}")
    require(not sites, f"the NeRF++ train step waits for the device at {sites}")

    calls = []
    with recorded_resamples(calls):
        state, _ = step(state, gen)
    k2 = k2_on_train_inputs(dev, calls)
    del calls

    # Descent on one fixed batch from fresh weights.
    batch = sample_nerfpp_batch(images, gen, PP_TRAIN_RAYS)
    base, _, fresh = nerfpp_train_setup(dev)
    fixed = []
    for _ in range(TRAIN_DESCENT + 1):
        fresh, m = base(fresh, batch, gen)
        fixed.append(m["loss"])
    fixed = [float(x) for x in fixed]
    print(f"  fixed batch: loss {fixed[0]:.5f} at the first step, {fixed[-1]:.5f} after "
          f"{TRAIN_DESCENT} steps")
    require(fixed[-1] < fixed[0], f"the loss on a fixed batch did not fall: {fixed}")
    return k2, dict(nerfpp_train_launches=counts["K2"], nerfpp_train_cdf_launches=counts[
        "K2 with CDF"], nerfpp_train_steps=steps, nerfpp_train_ms=ms,
        nerfpp_train_rays_per_s=rays_per_s, nerfpp_train_peak_gib=peak_gib,
        nerfpp_train_idle=idle, nerfpp_train_profile_ms=profile["groups"],
        nerfpp_train_k2_backward_profile_ms=backward[1],
        nerfpp_train_kernels_a_step=profile["kernels_a_step"])


def prd_lookup_gradient(camera, batch):
    """The gradient of the step's PRD term into ``distortion_noise`` through
    the inverse-distortion lookup alone: the keypoints' rays, which the
    distortion also warps, held fixed."""
    from scnerf_tpu_torch.camera import (
        get_distortion, get_extrinsic, get_intrinsic, pixels_to_rays,
    )
    from scnerf_tpu_torch.losses.prd import prd_loss
    from scnerf_tpu_torch.serve import fp32

    with fp32():
        E = get_extrinsic(camera, batch["pair_idx"])
        with torch.no_grad():
            k0, k1 = torch.floor(batch["kps0"]), torch.floor(batch["kps1"])
            r0 = pixels_to_rays(camera, k0[:, 0], k0[:, 1], c2w=E[0])
            r1 = pixels_to_rays(camera, k1[:, 0], k1[:, 1], c2w=E[1])
        prd, _ = prd_loss(batch["kps0"] + 0.5, batch["kps1"] + 0.5, r0, r1,
                          get_intrinsic(camera).detach(), E.detach(), mask=batch["kp_mask"],
                          method="NeRF++", distortion_k=get_distortion(camera),
                          image_wh=(PP_W, PP_H))
        return torch.autograd.grad(prd, camera.distortion_noise)[0]


def phase_nerfpp_fisheye(dev, card):
    """Phase 14: bench.py's fisheye camera with the distortion-aware PRD
    every step."""
    from scnerf_tpu_torch.train.curriculum import Curriculum

    print("== phase 14: NeRF++ fisheye step with the distortion-aware PRD every step")
    cur = Curriculum(add_prd=0, i_ray_dist_loss=1)
    rng = np.random.default_rng(SEED + 14)
    batch = {
        "px": rng.integers(0, PP_W, PP_TRAIN_RAYS).astype(np.float32),
        "py": rng.integers(0, PP_H, PP_TRAIN_RAYS).astype(np.float32),
        "img_idx": np.asarray(0),
        "target": rng.random((PP_TRAIN_RAYS, 3)).astype(np.float32),
        "min_depth": np.full(PP_TRAIN_RAYS, 1e-4, np.float32),
        **nerfpp_matches(rng, nerfpp_camera("cpu", fisheye=True), PP_PRD_MATCHES),
    }
    batch = to_device(batch, dev)
    step, optimizer, state = nerfpp_train_setup(dev, fisheye=True, with_prd=True,
                                                curriculum=cur)
    state, first = step(state, batch, torch.Generator(device=dev).manual_seed(SEED + 14))
    for path, g in optimizer.grads.items():
        require(g is not None and bool(torch.isfinite(g).all()),
                f"fisheye PRD step: {path} gradient missing or not finite")
    g_dist = optimizer.grads["camera/distortion_noise"]
    g_lookup = prd_lookup_gradient(nerfpp_train_setup(dev, fisheye=True)[2].params["camera"],
                                   batch)
    print(f"  prd_matches {float(first['prd_matches']):g} of {PP_PRD_MATCHES}, prd "
          f"{float(first['prd']):.5f}, loss {float(first['loss']):.5f}; distortion_noise "
          f"gradient {g_dist.tolist()}; PRD's gradient into it through the lookup alone "
          f"{g_lookup.tolist()}")
    require(float(first["prd_matches"]) > 0, "no valid match in the fisheye PRD step")
    require(bool(g_dist.abs().all()) and bool(g_lookup.abs().all())
            and bool(torch.isfinite(g_lookup).all()),
            "distortion_noise got no gradient through the distortion-aware PRD")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for _ in range(PP_TRAIN_WARMUP - 1):
        state, _ = step(state, batch, gen)
    state, metrics, ms = time_steps(lambda s: step(s, batch, gen), state, PP_TRAIN_TIMED // 2)
    losses = torch.stack([first["loss"]] + [m["loss"] for m in metrics])
    require(bool(torch.isfinite(losses).all()), "a fisheye PRD step's loss is not finite")
    rays_per_s = PP_TRAIN_RAYS / ms * 1e3
    print(f"  {ms:.3f} ms a step by CUDA events over {PP_TRAIN_TIMED // 2} steps: "
          f"{rays_per_s:.1f} train rays/s ({card})")
    state, sites = sync_sites(lambda s: step(s, batch, gen), state)
    print(f"  calls that wait for the device in one step: {sites or 'none'}")
    return dict(nerfpp_fisheye_prd_ms=ms, nerfpp_fisheye_prd_rays_per_s=rays_per_s,
                nerfpp_fisheye_prd_matches=float(first["prd_matches"]))


def phase_nerfpp_train_cpu_agreement(dev):
    """Phase 15: one NeRF++ train step on the card against the CPU port, the
    same params and injected randoms: without PRD, with the distortion-aware
    PRD on the fisheye camera, and with autoexpo and a mask; the control
    with TF32 on in the step."""
    from scnerf_tpu_torch.geometry.sphere import intersect_sphere
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.camera import FROZEN_LEAVES, pixels_to_rays
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.train import step as step_module
    from scnerf_tpu_torch.train.curriculum import Curriculum

    print("== phase 15: one NeRF++ train step on the card against the CPU port")
    n, (s0, s1) = PP_CPU_TRAIN_RAYS, PP_TRAIN_CASCADE
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 15)
    batch = {
        "px": rng.integers(0, PP_W, n).astype(np.float32),
        "py": rng.integers(0, PP_H, n).astype(np.float32),
        "img_idx": np.asarray(3),
        "target": rng.random((n, 3)).astype(np.float32),
        "min_depth": np.full(n, 1e-4, np.float32),
        "rands": [tuple(rng.random((n, s0)).astype(np.float32) for _ in range(2)),
                  tuple(rng.random((n, s1)).astype(np.float32) for _ in range(2))],
    }
    cases = {
        "without PRD": (dict(), batch),
        "distortion-aware PRD, fisheye": (
            dict(fisheye=True, with_prd=True, curriculum=Curriculum(add_prd=0, i_ray_dist_loss=1)),
            {**batch, **nerfpp_matches(rng, nerfpp_camera("cpu", fisheye=True), PP_PRD_MATCHES)}),
        "autoexpo, mask": (dict(autoexpo=True),
                           {**batch, "mask": (rng.random(n) < 0.7).astype(np.float32)}),
    }

    def one_step(device, b, spec, tf32=False, card=None, camera=None):
        """The metrics, gradients (on the CPU), K2 outputs and kink entries
        (:func:`kink_sides`) of one step on ``device``; ``tf32`` turns TF32
        on in the step (the control); ``card``, the K2 outputs and kink
        entries of the card's step, take the place of this step's own
        depths and kink sides; ``camera`` (initial values) that of the
        workload's."""
        step, optimizer, state = nerfpp_train_setup(device, camera=camera, **spec)
        before = pdf_cuda.diff_launches
        calls, kinks = [], []
        depths, card_kinks = card if card is not None else (None, None)
        fp32 = step_module.fp32
        if tf32:
            step_module.fp32 = tf32_on
        try:
            with recorded_resamples(calls, depths), kink_sides(kinks, card_kinks):
                _, metrics = step(state, to_device(b, device))
        finally:
            step_module.fp32 = fp32
        launched = pdf_cuda.diff_launches - before
        require(launched == (2 if device.type == "cuda" else 0),
                f"K2 launched {launched} times in one {device.type} NeRF++ train step")
        return ({k: float(v) for k, v in metrics.items()},
                {k: None if g is None else g.cpu() for k, g in optimizer.grads.items()},
                [c[3].detach().cpu() for c in calls], kinks)

    def nudged(b, spec, kind):
        """The CPU gradients of one step with one-ulp random moves of its
        inputs: each level-0 sample by about one ulp of its depth ("samples":
        fg depths run from the min depth to the sphere exit, bg inverse
        depths over [0, 1]), or each entry of the camera's initial
        intrinsics, poses and distortion ("rays")."""
        camera = nerfpp_camera(cpu, fisheye=spec.get("fisheye", False))
        if kind == "rays":
            leaves = bridge.camera_to_numpy(camera)
            for k in FROZEN_LEAVES:
                leaves[k] = one_ulp_moves(rng, leaves[k])
            moved = bridge.camera_from_numpy({**leaves, "config": camera.config}, device=cpu)
            return one_step(cpu, b, spec, camera=moved)[1]
        with torch.no_grad():
            o, d = pixels_to_rays(camera, torch.from_numpy(b["px"]), torch.from_numpy(b["py"]),
                                  image_idx=int(b["img_idx"]))
            far = intersect_sphere(o, d).numpy()[:, None]
        near = b["min_depth"][:, None]
        k = np.arange(s0) / (s0 - 1)
        width = (far - near) / (s0 - 1)
        dt_fg = np.spacing((near + (far - near) * k).astype(np.float32)) / width
        dt_bg = np.spacing(k.astype(np.float32)) * (s0 - 1)
        t_fg, t_bg = b["rands"][0]
        ups = lambda x: np.where(rng.random(x.shape) < 0.5, -1.0, 1.0)  # noqa: E731
        moved = (np.clip(t_fg + ups(t_fg) * dt_fg, 0, 1).astype(np.float32),
                 np.clip(t_bg + ups(t_bg) * dt_bg, 0, 1).astype(np.float32))
        return one_step(cpu, {**b, "rands": [moved, b["rands"][1]]}, spec)[1]

    for case, (spec, b) in cases.items():
        # K2 on the card and its twin on the CPU, each on its own CDF: a
        # sample whose count differs (a u within rounding of a CDF entry, or
        # a row whose CDF the card's scan makes decrease) moves to the next
        # bin, and its ray's level-1 query with it. Such flips are held to
        # phase 5's share, and the CPU step then takes the card's resampled
        # depths (its own derivative), so that a flip does not count again
        # in the gradients.
        # Likewise a ReLU whose pre-activation lies within rounding of 0 may
        # take the other side on the other device, and one such unit at a
        # sample of large weight (the last bg sample carries most of its
        # ray's bg weight) moves its layer's gradient by 1e-2 (PERF.md §6).
        # The CPU step takes the card's side there, and the flipped entries
        # are shown to lie within KINK of 0 on both devices.
        card_m, card_g, card_r, card_k = one_step(dev, b, spec)
        cpu_m, cpu_g, cpu_r, cpu_k = one_step(cpu, b, spec, card=(card_r, card_k))
        shares = [float(((a - c).abs() > 1e-4).float().mean()) for a, c in zip(card_r, cpu_r)]
        require(all(x < 1e-3 for x in shares), f"{case}: K2 flips {shares} between the card "
                                               "and the CPU")
        flipped = torch.cat([torch.cat([mine, theirs]) for _, mine, theirs in cpu_k])
        near = sum(len(idx) for idx, _ in card_k)
        largest = float(flipped.abs().max()) if len(flipped) else 0.0
        require(largest < KINK, f"{case}: a kink flipped at |pre-activation| {largest}")
        # float32's own spread: each leaf's largest change over four CPU
        # steps with one-ulp moves of the inputs, two of the level-0 samples
        # and two of the rays (the camera's initial intrinsics, poses and
        # distortion). The card is held to 1e-4 or, where larger, that
        # spread.
        cpu_own_g = one_step(cpu, b, spec)[1]
        spread = [nudged(b, spec, kind) for kind in ("samples", "rays") for _ in range(2)]
        limits = {path: max(1e-4, max(rel_l2(g[path], g_cpu) for g in spread))
                  for path, g_cpu in cpu_own_g.items() if g_cpu is not None}
        rel_loss, rows = over_limits(card_m, card_g, cpu_m, cpu_g, limits)
        extra = (f"; prd {card_m['prd']:.6f} / {cpu_m['prd']:.6f}, prd_matches "
                 f"{card_m['prd_matches']:g} / {cpu_m['prd_matches']:g}") if "prd" in cpu_m else ""
        print(f"  {case}, {n} rays: loss {card_m['loss']:.7f} card, {cpu_m['loss']:.7f} CPU "
              f"(relative {rel_loss:.3e}){extra}; K2 flips (fg, bg) {shares}; kinks: "
              f"{len(flipped) // 2} of the card's {near} dense outputs within {KINK:g} of 0 "
              f"on the other side on the CPU (largest |value| on either {largest:.3e}); {len(rows)} "
              f"leaves, each held to 1e-4 or the CPU's spread under one-ulp moves of the "
              f"level-0 samples and of the rays")
        for ratio, path, rel, limit in rows[:6] + [r for r in rows[6:] if r[1].startswith(
                ("camera/", "levels/0/autoexpo", "levels/1/autoexpo"))]:
            print(f"    {path}: card vs CPU {rel:.3e}, limit {limit:.3e} ({ratio:.2f} of it)")
        for ratio, path, rel, limit in rows:
            require(ratio <= 1.0, f"{case}: card vs CPU gradient of {path}: relative L2 "
                                  f"{rel:.3e} over its limit {limit:.3e}")
        require(rel_loss <= 1e-5, f"{case}: card vs CPU loss relative error {rel_loss}")
        if "prd" in cpu_m:
            require(card_m["prd_matches"] == cpu_m["prd_matches"] > 0,
                    f"{case}: prd_matches {card_m['prd_matches']} / {cpu_m['prd_matches']}")
        m, g, _, _ = one_step(dev, b, spec, tf32=True)
        rel_loss, rows = over_limits(m, g, cpu_m, cpu_g, limits)
        failed = [f"{path} {ratio:.2f}x" for ratio, path, _, _ in rows if ratio > 1.0]
        print(f"  control, TF32 on in the step: loss relative {rel_loss:.3e}"
              f"{' (over 1e-5)' if rel_loss > 1e-5 else ''}; {len(failed)} leaves over their "
              f"limits: {', '.join(failed[:8]) or 'none'}")
        require(rel_loss > 1e-5 or bool(failed), f"{case}: TF32 on in the step passes the limits")


# Phases 16-17: the training CLI on a seeded scene of fern's shape
# (configs/llff/fern_ours.txt at factor 8: 20 views of 378x504, fern's hwf).
FERN_CONFIG = os.path.join("configs", "llff", "fern_ours.txt")
FERN_VIEWS = 20
FERN_H, FERN_W = 378, 504
FERN_HWF = (3024.0, 4032.0, 3260.0)  # fern's full size and focal
FERN_BOUNDS = (2.0, 12.0)
FERN_MATCH_POINTS = 200
DRIVER_STEPS, DRIVER_RESUME_STEPS = 60, 80
DRIVER_TURN_STEPS = 10  # one PRD step in each span of ten (i_ray_dist_loss 10)
DRIVER_TURNS = 3
DRIVER_CPU_RAYS = 1024
PRD_INTRINSICS_MOVE = (30.0, -20.0, 15.0, -10.0)  # fx, fy, cx, cy in pixels (phase 17)


def write_fern_scene(root: str) -> str:
    """A seeded forward-facing LLFF scene of fern's shape under ``root``:
    ``poses_bounds.npy`` for 20 views with fern's hwf column and seeded
    bounds, cameras within a few degrees of looking down -z, and 20
    378x504 PNGs of smooth seeded textures (sums of sinusoids) in both
    ``images/`` and ``images_8/``, written by ``core/imaging.write_png``."""
    from scnerf_tpu_torch.core.imaging import to8b, write_png

    rng = np.random.RandomState(SEED + 16)
    axis = rng.randn(FERN_VIEWS, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    R = rodrigues(axis, np.deg2rad(rng.uniform(0.0, 3.0, FERN_VIEWS)))
    t = rng.uniform([-0.5, -0.4, -0.1], [0.5, 0.4, 0.1], (FERN_VIEWS, 3))
    rows = []
    for i in range(FERN_VIEWS):
        # LLFF stores [down, right, back, t, hwf]; the loader turns it into
        # OpenGL's [right, up, back].
        stored = np.stack([-R[i][:, 1], R[i][:, 0], R[i][:, 2], t[i], FERN_HWF], axis=1)
        rows.append(np.concatenate([stored.reshape(-1), FERN_BOUNDS]))
    os.makedirs(root)
    np.save(os.path.join(root, "poses_bounds.npy"), np.asarray(rows))
    yy, xx = np.mgrid[0:FERN_H, 0:FERN_W].astype(np.float64)
    for i in range(FERN_VIEWS):
        img = np.zeros((FERN_H, FERN_W, 3))
        for c in range(3):
            for _ in range(4):
                fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([FERN_W, FERN_H])
                img[..., c] += np.sin(fx * xx + fy * yy + rng.uniform(0, 2 * np.pi))
        png = to8b(0.5 + 0.45 * img / 4)
        for sub in ("images", "images_8"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            write_png(os.path.join(root, sub, f"IMG_{i:04d}.png"), png)
    return root


def projected_matches(poses, K, n_points: int, seed: int):
    """Matches between every pair of ``poses`` (c2w, OpenGL): seeded points
    in front of the cameras projected into both images, those inside both
    kept."""
    from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches

    pts = np.random.RandomState(seed).uniform([-1.0, -0.75, -5.0], [1.0, 0.75, -2.0],
                                              (n_points, 3))
    kps, inside = [], []
    for c2w in poses:
        cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
        k = np.stack([K[0, 2] + K[0, 0] * cam[:, 0] / -cam[:, 2],
                      K[1, 2] - K[1, 1] * cam[:, 1] / -cam[:, 2]], -1).astype(np.float32)
        kps.append(k)
        inside.append((k[:, 0] >= 0) & (k[:, 0] < FERN_W) & (k[:, 1] >= 0) & (k[:, 1] < FERN_H))
    cache = PrecomputedMatches()
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            keep = inside[i] & inside[j]
            cache.put(i, j, PairMatches(kps[i][keep], kps[j][keep]))
    return cache


class StepRecorder:
    """A train step function wrapped so that each call is bracketed by CUDA
    events and its metrics kept; both are read after the run (recording an
    event does not wait for the device)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, state, batch, generator):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = self.fn(state, batch, generator)
        end.record()
        self.calls.append((state.step, start, end, metrics))
        return state, metrics

    def read(self):
        """[(step, ms, metrics as floats)] of every call."""
        torch.cuda.synchronize()
        return [(step, s.elapsed_time(e), {k: float(v) for k, v in m.items()})
                for step, s, e, m in self.calls]


def percentiles(ms: list) -> dict:
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95))} if ms else {"n": 0}


def metric_rows(expdir: str) -> list:
    with open(os.path.join(expdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_driver(dev, card, root):
    """Phase 16: the training CLI on the card at fern's full width on a
    seeded scene of fern's shape: 60 steps, a resume to 80, the test-view
    evaluation; then the loop's own cost, the evaluation hooks, the
    checkpoint's cost."""
    import io
    import warnings

    from scnerf_tpu_torch.cli import train as cli
    from scnerf_tpu_torch.core.imaging import read_png
    from scnerf_tpu_torch.data.llff import load_llff
    from scnerf_tpu_torch.metrics.ssim import ssim
    from scnerf_tpu_torch.train import checkpoint, driver
    from scnerf_tpu_torch.train.logging_utils import MetricLogger

    print("== phase 16: the training CLI at full fern width on the card (seeded fern-shaped "
          "scene)")
    started = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene = write_fern_scene(os.path.join(root, "fern"))
    logs = os.path.join(root, "logs")
    expdir = os.path.join(logs, "fern_ours")
    os.makedirs(expdir)
    data = load_llff(scene, factor=8, llffhold=8)
    train_matches = projected_matches(data.gt_poses[data.i_train], data.gt_intrinsic,
                                      FERN_MATCH_POINTS, SEED + 16)
    train_matches.save(os.path.join(expdir, "matches.npz"))
    n_matches = [train_matches.get(i, j).kps0.shape[0] for i, j in train_matches.pairs()]
    print(f"  scene: {FERN_VIEWS} views of {FERN_H}x{FERN_W}, train {data.i_train.tolist()}, test "
          f"{data.i_test.tolist()}; matches.npz: {len(n_matches)} pairs, {min(n_matches)}-"
          f"{max(n_matches)} matches a pair; written in {time.perf_counter() - started:.2f} s")

    argv = ["--config", FERN_CONFIG, "--datadir", scene, "--basedir", logs,
            "--add_ie", "0", "--add_od", "0", "--add_prd", "0",
            "--i_print", "10", "--i_weights", "30"]
    captured = []
    build = driver.build_experiment

    def capturing(*args, **kwargs):
        exp = build(*args, **kwargs)
        exp.step_fn = StepRecorder(exp.step_fn)
        exp.step_prd_fn = StepRecorder(exp.step_prd_fn)
        captured.append(exp)
        return exp

    driver.build_experiment = capturing
    runs = []
    try:
        for first, steps in ((0, DRIVER_STEPS), (DRIVER_STEPS, DRIVER_RESUME_STEPS)):
            torch.cuda.synchronize()
            reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv + ["--steps", str(steps)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts()["K1"]
            text = out.getvalue()
            print("  " + "\n  ".join(text.strip().splitlines()))
            require(rc == 0, f"cli.train.main returned {rc}")
            exp = captured[-1]
            require(exp.device.type == dev.type, f"the CLI built its experiment on {exp.device}")
            resumed = f"[resume] restored step {first} from" in text
            require(resumed == (first > 0), f"run to {steps}: resume line {resumed}")
            chunks = -(-exp.H * exp.W // exp.render_cfg.chunk)
            want = (steps - first) + 3 * chunks
            print(f"  run to step {steps}: {seconds:.2f} s; K1 launched {launches} times: "
                  f"{steps - first} train steps + 3 test views x {chunks} chunks = {want}")
            require(launches == want, f"K1 launched {launches} times, want {want}")
            eval_line = [line for line in text.splitlines() if line.startswith("[eval]")]
            require(len(eval_line) == 1, f"no [eval] line in run to {steps}")
            ckpts = checkpoint.list_checkpoint_steps(os.path.join(expdir, "ckpts"))
            print(f"  checkpoints after the run to {steps}: {ckpts}")
            runs.append(dict(seconds=seconds, launches=launches, ckpts=ckpts))
    finally:
        driver.build_experiment = build
    require(runs[0]["ckpts"] == [30, 60], f"checkpoints after 60 steps: {runs[0]['ckpts']}")
    require(runs[1]["ckpts"] == [30, 60, 80], f"checkpoints after 80: {runs[1]['ckpts']}")

    rows = metric_rows(expdir)
    for row in rows:
        bad = [k for k, v in row.items() if isinstance(v, float) and not math.isfinite(v)]
        require(not bad, f"metrics.jsonl row at step {row['step']}: {bad} not finite")
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    print(f"  logged losses: {[(s, round(v, 5)) for s, v in losses]}")
    require([s for s, _ in losses] == list(range(10, DRIVER_RESUME_STEPS + 1, 10)),
            f"logged steps {[s for s, _ in losses]}")
    require(losses[-1][1] < losses[0][1], f"the last logged loss {losses[-1][1]} is not below "
                                          f"the first {losses[0][1]}")
    finals = [r for r in rows if "final_psnr" in r]
    require([r["step"] for r in finals] == [DRIVER_STEPS, DRIVER_RESUME_STEPS],
            f"final rows at {[r['step'] for r in finals]}")
    for r in finals:
        require(0.0 < r["final_ssim"] < 1.0 and math.isfinite(r["final_psnr"])
                and r["final_n_views"] == 3, f"final evaluation {r}")
    timer = {k: rows[-2][k] for k in ("steps", "p50_ms", "p95_ms") if k in rows[-2]}

    records = {"plain": [], "prd": []}
    prd_matches = []
    for run, first in zip(captured, (0, DRIVER_STEPS)):
        for recorder, kind in ((run.step_fn, "plain"), (run.step_prd_fn, "prd")):
            for step, ms, m in recorder.read():
                if step > first + 2:  # after each run's first two steps
                    records[kind].append(ms)
                if kind == "prd":
                    prd_matches.append(m["prd_matches"])
    # PRD ran at its cadence on a real match batch. Only the first PRD step
    # sees the camera at its initial values, the ground truth, where every
    # projected match is valid; from there the whole camera trains from
    # step 0 on a field of random weights, the poses wander, and a match
    # counts only while both reprojections stay within 5 px^2.
    require(len(prd_matches) == DRIVER_RESUME_STEPS // 10 and prd_matches[0] > 0,
            f"prd_matches on the PRD steps: {prd_matches}")
    exp = captured[-1]
    with torch.no_grad():
        from scnerf_tpu_torch.camera.model import get_extrinsics

        moved = (get_extrinsics(exp.state.params["camera"]).cpu()
                 - torch.from_numpy(exp.gt_poses[exp.i_train])).abs()
    step_ms = {kind: percentiles(ms) for kind, ms in records.items()}
    print(f"  both runs, by CUDA events around each step but each run's first two "
          f"({card}): plain {step_ms['plain']}, PRD {step_ms['prd']}; prd_matches "
          f"{prd_matches} (the train poses at step 80 off the ground truth by up to "
          f"{float(moved[:, :3, :3].max()):.4f} in rotation entries and "
          f"{float(moved[:, :3, 3].max()):.4f} in translation); the loop's StepTimer at step "
          f"80 (host clock) {timer}")
    exp.logger = MetricLogger(expdir)  # the CLI closed its own; this one appends
    plain_fn, prd_fn = exp.step_fn.fn, exp.step_prd_fn.fn
    exp.step_fn, exp.step_prd_fn = plain_fn, prd_fn

    # The steady loop between print and checkpoint steps never waits for
    # the device.
    log = exp.cfg.logging
    log.i_print = log.i_weights = 10**9
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            driver.train_loop(exp, exp.state.step + DRIVER_TURN_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    sites = sorted({f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    print(f"  calls that wait for the device in {DRIVER_TURN_STEPS} loop steps (one with PRD): "
          f"{sites or 'none'}")
    require(not sites, f"the steady loop waits for the device at {sites}")

    # The loop against the same step functions on one ready device batch,
    # in turns: the gap is the host loop's own cost (draws, gather, copies).
    ready = driver.sample_batch(exp, exp.state.step)
    ready_prd = dict(ready, **driver.sample_prd_batch(exp))
    seed = exp.cfg.logging.seed

    def loop_span():
        driver.train_loop(exp, exp.state.step + DRIVER_TURN_STEPS)

    def ready_span():
        for _ in range(DRIVER_TURN_STEPS):
            it = exp.state.step
            gen = driver.step_generator(seed, it, dev)
            if it % DRIVER_TURN_STEPS == 0:
                exp.state, _ = prd_fn(exp.state, ready_prd, gen)
            else:
                exp.state, _ = plain_fn(exp.state, ready, gen)

    turns = {"loop": [], "ready": []}
    for _ in range(DRIVER_TURNS):
        for name, span in (("loop", loop_span), ("ready", ready_span)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            span()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3 / DRIVER_TURN_STEPS)
    loop_ms = statistics.median(turns["loop"])
    ready_ms = statistics.median(turns["ready"])
    t0 = time.perf_counter()
    for it in range(50):
        driver.sample_batch(exp, it)
    draw_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    rays_per_s = TRAIN_RAYS / loop_ms * 1e3
    print(f"  spans of {DRIVER_TURN_STEPS} steps (one with PRD), {DRIVER_TURNS} turns each, host "
          f"clock to a synchronize ({card}): the loop {loop_ms:.3f} ms a step "
          f"({rays_per_s:.1f} train rays/s), the same steps on one ready batch {ready_ms:.3f} ms; "
          f"the loop's own cost {loop_ms - ready_ms:.3f} ms a step; sample_batch alone "
          f"{draw_ms:.3f} ms of host time a call (turns {turns})")

    # The evaluation hooks, with matches between the test views injected.
    exp.eval_match_cache = projected_matches(exp.gt_poses[exp.i_test], exp.gt_intrinsic,
                                             FERN_MATCH_POINTS, SEED + 17)
    exp.eval_pair_list = np.array(exp.eval_match_cache.pairs())
    log.i_print = log.i_testset = log.i_img = log.camera_log = 2
    log.i_video = 0
    hook_step = exp.state.step + 2
    reset_launches()
    driver.train_loop(exp, hook_step, eval_hooks=True)
    torch.cuda.synchronize()
    hook_launches = launch_counts()["K1"]
    chunks = -(-exp.H * exp.W // exp.render_cfg.chunk)
    require(hook_launches == 2 + 3 * chunks,
            f"K1 launched {hook_launches} times in 2 steps and 3 renders of {chunks} chunks")
    hook_row = {k: v for r in metric_rows(expdir) if r["step"] == hook_step for k, v in r.items()}
    for k in ("test/psnr", "test/ssim", "test/prd", "test/prd_val", "val/psnr", "camera/fx",
              "camera/fx_err", "camera/ray_o_noise_mean"):
        require(k in hook_row and math.isfinite(hook_row[k]), f"hook metric {k}: "
                                                              f"{hook_row.get(k)}")
    val_png = read_png(os.path.join(expdir, f"val_{hook_step:08d}.png"))
    grid_png = read_png(os.path.join(expdir, "images",
                                     f"camera_ray_o_noise_{hook_step:08d}.png"))
    require(val_png.shape == (FERN_H, FERN_W, 3), f"val PNG {val_png.shape}")
    require(grid_png.shape == tuple(exp.state.params["camera"].ray_o_grid.shape),
            f"camera-log PNG {grid_png.shape}")
    print(f"  eval hooks at step {hook_step}: " + ", ".join(
        f"{k}={hook_row[k]:.5g}" for k in sorted(hook_row) if k.startswith(("test/", "val/"))
        or k in ("camera/fx", "camera/fx_err")) + f"; val and camera-log PNGs read back; K1 "
          f"launched {hook_launches} times (2 steps + 3 renders)")

    # One test view: render, SSIM, checkpoint.
    idx = int(exp.i_test[0])
    c2w = driver.aligned_eval_extrinsic(exp, idx)
    render_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = driver.render_image(exp, c2w)  # ends in the device-to-host copies
        render_s.append(time.perf_counter() - t0)
    rgb = torch.from_numpy(out["rgb"]).to(dev)
    target = torch.from_numpy(exp.images[idx]).to(dev)
    ssim_ms = per_call_ms(lambda: ssim(rgb, target), calls=10)
    ckpt_dir = os.path.join(root, "timed_ckpts")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save_checkpoint(ckpt_dir, exp.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    restored = checkpoint.restore_checkpoint(ckpt_dir, exp.state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(restored.step == exp.state.step, "the timed checkpoint did not restore its step")
    exp.logger.close()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    seconds = time.perf_counter() - started
    n_rays = FERN_H * FERN_W
    print(f"  one {FERN_H}x{FERN_W} test view: {render_s[-1]:.3f} s "
          f"({n_rays / render_s[-1]:.1f} rays/s; first call {render_s[0]:.3f} s), SSIM "
          f"{ssim_ms:.3f} ms by CUDA events; checkpoint {ckpt_bytes} bytes, save {save_ms:.1f} "
          f"ms, restore {restore_ms:.1f} ms; peak memory {peak_gib:.3f} GiB; phase "
          f"{seconds:.1f} s ({card})")
    record = dict(
        driver_launches=runs[0]["launches"] + runs[1]["launches"],
        driver_run_s=[r["seconds"] for r in runs],
        driver_step_ms=step_ms, driver_step_timer=timer,
        driver_loop_ms=loop_ms, driver_ready_ms=ready_ms, driver_draw_ms=draw_ms,
        driver_rays_per_s=rays_per_s, driver_final=finals[-1],
        driver_render_s=render_s[-1], driver_render_rays_per_s=n_rays / render_s[-1],
        driver_ssim_ms=ssim_ms, driver_ckpt_bytes=ckpt_bytes, driver_ckpt_save_ms=save_ms,
        driver_ckpt_restore_ms=restore_ms, driver_peak_gib=peak_gib,
        driver_phase_s=seconds)
    return record, exp, out


def phase_driver_cpu_agreement(exp, card_out):
    """Phase 17: the card's evaluation against the CPU port's from the same
    weights on one test view, and the SSIM control with TF32 on."""
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.metrics import ssim as ssim_module
    from scnerf_tpu_torch.train import driver
    from scnerf_tpu_torch.train.step import create_train_state

    print("== phase 17: the driver's evaluation on the card against the CPU port")
    started = time.perf_counter()
    cpu = driver.build_experiment(exp.cfg, None, device="cpu")
    tree = bridge.train_params_to_numpy(exp.state.params)
    tree["camera"]["config"] = exp.state.params["camera"].config
    cpu.state = create_train_state(bridge.train_params_to_torch(tree, device="cpu"),
                                   cpu.optimizer)
    cpu.eval_pair_list, cpu.eval_match_cache = exp.eval_pair_list, exp.eval_match_cache

    idx = int(exp.i_test[0])
    card_c2w = driver.aligned_eval_extrinsic(exp, idx).cpu()
    cpu_c2w = driver.aligned_eval_extrinsic(cpu, idx)
    pose_err = float((card_c2w - cpu_c2w).abs().max())

    rng = np.random.default_rng(SEED + 17)
    pick = rng.choice(FERN_H * FERN_W, DRIVER_CPU_RAYS, replace=False)
    px = torch.from_numpy((pick % FERN_W).astype(np.float32))
    py = torch.from_numpy((pick // FERN_W).astype(np.float32))
    cpu_rgb = driver.render_pixels(cpu, card_c2w, px, py)["rgb"].numpy()
    card_rgb = card_out["rgb"].reshape(-1, 3)[pick]
    err = np.abs(cpu_rgb - card_rgb)
    med, worst = float(np.median(err)), float(err.max())

    target = exp.images[idx]
    rgb_card, target_card = (torch.from_numpy(x).to(exp.device) for x in (card_out["rgb"], target))
    card_ssim = float(ssim_module.ssim(rgb_card, target_card))
    cpu_ssim = float(ssim_module.ssim(torch.from_numpy(card_out["rgb"]),
                                      torch.from_numpy(target)))
    # The controls: SSIM as JAX computes it, the 2-D window by F.conv2d,
    # through cuDNN in float32 with the window computed on the CPU and on the
    # card, through PyTorch's own convolution (cuDNN off), and through cuDNN
    # with TF32.
    controls = {
        "conv2d_cudnn_fp32": conv2d_ssim(rgb_card, target_card, fp32_cudnn, "cpu"),
        "conv2d_cudnn_fp32_card_window": conv2d_ssim(rgb_card, target_card, fp32_cudnn,
                                                     exp.device),
        "conv2d_no_cudnn_fp32": conv2d_ssim(rgb_card, target_card, fp32_no_cudnn, "cpu"),
        "conv2d_cudnn_tf32": conv2d_ssim(rgb_card, target_card, tf32_on, "cpu"),
        "conv2d_cpu": conv2d_ssim(torch.from_numpy(card_out["rgb"]), torch.from_numpy(target),
                                  contextlib.nullcontext, "cpu"),
    }
    # The val protocol evaluates the learned intrinsics and ray noise with
    # the GT poses. After 150 steps they sit at the ground truth, and PRD
    # reads float32's rounding (about 5e-7 px^2, printed); so it is compared
    # with the learned intrinsics moved by a few pixels, on both devices
    # alike, where each match's distance is a few px^2.
    trained = [driver.evaluate_prd_split(e, mode="val")["prd_val"] for e in (exp, cpu)]
    for e in (exp, cpu):
        with torch.no_grad():
            noise = e.state.params["camera"].intrinsics_noise
            noise.add_(torch.tensor(PRD_INTRINSICS_MOVE, device=noise.device))
    card_prd = driver.evaluate_prd_split(exp, mode="val")["prd_val"]
    cpu_prd = driver.evaluate_prd_split(cpu, mode="val")["prd_val"]
    rel = abs(card_prd - cpu_prd) / max(abs(cpu_prd), 1e-30)
    print(f"  aligned_eval_extrinsic max|err|={pose_err:.3e}; render rgb on {DRIVER_CPU_RAYS} "
          f"pixels median|err|={med:.3e} max|err|={worst:.3e}; ssim card {card_ssim:.8f} cpu "
          f"{cpu_ssim:.8f} (|diff| {abs(card_ssim - cpu_ssim):.3e}); prd_val with the trained "
          f"camera card {trained[0]:.4e} cpu {trained[1]:.4e}, with the intrinsics moved by "
          f"{PRD_INTRINSICS_MOVE} px card {card_prd:.8f} cpu {cpu_prd:.8f} (rel {rel:.3e}); "
          f"{time.perf_counter() - started:.1f} s")
    diffs = {name: abs(v - cpu_ssim) for name, v in controls.items()}
    for name, v in controls.items():
        print(f"  control, ssim by {name}: {v:.8f}, |diff| {diffs[name]:.3e} from the port's on "
              f"the CPU (limit 1e-6: {'broken' if diffs[name] >= 1e-6 else 'kept'})")
    require(pose_err < 1e-5, f"aligned_eval_extrinsic max |err| {pose_err:.3e} >= 1e-5")
    require(med < 1e-5 and worst < 1e-3, f"render_image rgb median|err|={med:.3e} "
                                         f"max|err|={worst:.3e}")
    require(abs(card_ssim - cpu_ssim) < 1e-6, f"ssim card {card_ssim} cpu {cpu_ssim}")
    require(rel < 1e-5, f"evaluate_prd_split card {card_prd} cpu {cpu_prd} (rel {rel:.3e})")
    return dict(driver_cpu_pose_err=pose_err, driver_cpu_rgb_median_err=med,
                driver_cpu_rgb_max_err=worst, driver_cpu_ssim_diff=abs(card_ssim - cpu_ssim),
                driver_cpu_prd_rel=rel,
                **{f"driver_ssim_{name}_diff": d for name, d in diffs.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scnerf_tpu_torch.kernels import _build

    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print("== phase 1: card, versions, kernel build")
    print(f"  card: {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + len(OPS_SOURCES)) as pool:
        builds = ([pool.submit(_build.build, name) for name in SOURCES]  # one nvcc each
                  + [pool.submit(_build.build_ops, name) for name in OPS_SOURCES])
        libs = [b.result() for b in builds]
    for name in SOURCES:
        _build.load(name)
    for name in OPS_SOURCES:
        _build.load_ops(name)
    print(f"  built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    routes = {"K1, K2": ("registered operators torch.ops.scnerf_tpu_torch.sample_pdf[_fwd]",
                         _build.ops_library_path("sample_pdf")),
              "K3": ("ctypes", _build.library_path("fused_mlp")),
              "K4": ("ctypes", _build.library_path("searchsorted"))}
    for kernels, (route, lib) in routes.items():
        print(f"  {kernels}: {route}, {lib}")
    for name in (*SOURCES, *(f"{name}_op" for name in OPS_SOURCES)):
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():  # ptxas's report; not the host compiler's warnings
            lines = [line for line in log.read_text().splitlines()
                     if line.startswith("ptxas") or "spill" in line]
            print(f"  {name}: " + "\n  ".join(lines))

    record = phase_kernels(dev)
    slice_ = make_slice(dev)
    requests, outputs, launches = phase_slice(dev, card, slice_)
    phase_cpu_agreement(slice_, requests, outputs)
    queries = record_field_queries(dev, slice_, requests)
    model_cfg = slice_[0]
    del slice_, requests, outputs

    pp_record = phase_k2(dev)
    pp_slice = make_nerfpp_slice(dev)
    pp_requests, pp_outputs, pp_launches = phase_nerfpp_slice(dev, card, pp_slice)
    phase_nerfpp_cpu_agreement(pp_slice, pp_requests, pp_outputs)
    del pp_slice, pp_requests, pp_outputs

    search_record, search_launches = phase_k4(dev)
    field_record, field_launches = phase_k3(model_cfg, queries)
    del queries

    train_slice = make_slice(dev)
    train_record = phase_train(dev, card, train_slice)
    prd_record = phase_prd_train(dev, card, train_slice)
    phase_train_cpu_agreement(dev, train_slice)
    del train_slice

    pp_train_k2, pp_train_record = phase_nerfpp_train(dev, card)
    fisheye_record = phase_nerfpp_fisheye(dev, card)
    phase_nerfpp_train_cpu_agreement(dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as root:
        driver_record, driver_exp, driver_out = phase_driver(dev, card, root)
        driver_record.update(phase_driver_cpu_agreement(driver_exp, driver_out))
        del driver_exp, driver_out

    seconds = time.perf_counter() - started
    print(f"chip_smoke: {seconds:.1f} s in all, the kernels' build included")
    print(json.dumps({"kernels": [{
        "name": "sample_pdf",
        "route": "cuda",
        "host_route": "operator",
        "source": "scnerf_tpu_torch/csrc/sample_pdf.cu",
        "replaces": "scnerf_tpu/kernels/pdf_pallas.py:66",
        "launches": launches,
        "train_launches": train_record["train_launches"],
        "train_max_abs_err": train_record["train_max_abs_err"],
        "driver_launches": driver_record["driver_launches"],
        **record,
    }, {
        "name": "sample_pdf_nerfpp",
        "route": "cuda",
        "host_route": "operator",
        "source": "scnerf_tpu_torch/csrc/sample_pdf.cu",
        "replaces": "scnerf_tpu/kernels/pdf_pallas.py:194",
        "launches": pp_launches,
        **pp_record,
        "train_launches": pp_train_record["nerfpp_train_launches"],
        "train_cdf_launches": pp_train_record["nerfpp_train_cdf_launches"],
        **pp_train_k2,
    }, {
        "name": "searchsorted",
        "route": "cuda",
        "host_route": "ctypes",
        "source": "scnerf_tpu_torch/csrc/searchsorted.cu",
        "replaces": "scnerf_tpu/kernels/searchsorted_pallas.py:35",
        "launches": search_launches,
        **search_record,
    }, {
        "name": "fused_query_field",
        "route": "cuda",
        "host_route": "ctypes",
        "source": "scnerf_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "scnerf_tpu/kernels/mlp_pallas.py:85",
        "launches": field_launches,
        **field_record,
    }], "train": {**train_record, **prd_record, **pp_train_record, **fisheye_record,
                  **driver_record},
        "seconds": seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
