"""Drive the PyTorch port's NeRF and NeRF++ serving paths, its NeRF and
NeRF++ train steps, its NeRF and NeRF++ training CLI, its render CLI, its
SuperPoint + SuperGlue matcher, its runtime modules and its
self-calibration experiments and examples once on an NVIDIA card.

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

18. The NeRF++ training CLI at full Truck width: ``cli.train.main``
    in-process with ``configs/tanks_and_temples/tat_training_Truck_ours.txt``
    as it stands (fg and bg MLPNets 8x256, multires 10/4, cascade 64,128,
    N_rand 256, eval chunks of 4,096, multiplicative intrinsics noise, PRD
    one step in ten) on a seeded scene of Truck's shape: a ``train/`` split
    of phase 6's 12 poses and a ``validation/`` split of one more, 546x980
    smooth seeded textures, ``intrinsics/`` and ``pose/`` files, and
    ``matches.npz`` projected from 200 seeded points in OpenCV's
    convention. ``--ray_loss_type proj_ray_dist --add_ie 0 --add_od 0
    --add_prd 0 --i_print 10 --i_weights 30 --i_testset 60 --i_img 60
    --camera_log 30``, 60 steps: every logged metric finite, checkpoints at
    30 and 60, the hooks' metrics and PNGs (read back), valid matches on the
    first PRD step, K2 twice a train step (once with the CDF) and twice a
    chunk of the hooks' held-out renders; then ten loop steps (one with
    PRD) with no wait on the device, the loop's ms a step and train rays/s
    over spans of ten, one held-out view's render time, SSIM's time, a
    checkpoint's bytes and save time, peak memory; each step's ms by CUDA
    events, plain and PRD apart; the loop against the same steps on a ready
    batch in turns, and the host batch's draws alone.
19. The render CLI: ``cli.render.main --split test --max_views 1`` on
    phase 18's experiment (restores step 60, writes ``000.png``,
    ``000_fg.png``, ``000_bg.png``, ``000_depth.png`` and the summary, read
    back; K2 twice a chunk of its two renders) and on phase 16's (K1 once a
    chunk of two renders), ``cli.train.main --render_only True --render_test
    True`` on phase 16's (the same), and ``render_training_video`` of three
    frames (K1 once a chunk; the video, or its ``.npz`` without an
    encoder).
20. Phase 18's trained experiment carried to the CPU port: rgb, fg_rgb and
    bg_rgb of 1,024 seeded pixels of the held-out view through the learned
    camera at its pose, median |err| < 1e-5 and max < 1e-3; SSIM of the
    card's render against its target on both devices within 1e-6;
    ``evaluate_nerfpp_prd`` within relative 1e-5 at the trained camera (or,
    where its distances read float32's rounding, with the learned
    intrinsics moved by about a pixel), the CPU's own spread under one-ulp
    moves of the keypoints, the initial intrinsics or the initial poses
    printed beside it; LPIPS with seeded random VGG16
    weights within relative 1e-4 (and its time on the card); the control,
    LPIPS with cuDNN's TF32 on, printed.
21. The matcher at the published width: SuperPoint 64-64-128-128 with its
    256-wide heads, SuperGlue hidden 256, keypoint encoder 32-64-128-256,
    ``["self", "cross"] * 9`` with 4 heads (13,324,162 parameters), seeded
    random weights (transformers' initialisation, the detector's
    convolutions at He's scale so that its scores are not all 1/65) written
    as ``config.json``, ``preprocessor_config.json`` and
    ``model.safetensors`` into a temporary hub cache and loaded by
    ``matcher_from_config`` with ``HF_HUB_CACHE`` pointing there, with
    ``CameraFlags``' knobs (1,024 keypoints, NMS radius 4, threshold 0.005,
    20 Sinkhorn rounds) and match threshold 0. Seeded textured pairs with a
    16-pixel shift at fern's 378x504, Truck's 546x980 and LLFF's 756x1008:
    ms a pair by the host clock and its split (the host's preprocessing,
    SuperPoint, the GNN, Sinkhorn with the extraction by CUDA events, the
    host's post-processing), keypoints an image, mutual matches, the waits
    for the device a pair (``torch.cuda.set_sync_debug_mode``), peak
    memory. Then the card against the CPU port on the same pixels: at least
    99% of each image's keypoints shared, their scores within 1e-5,
    descriptors within 1e-4, the log assignment between them within
    relative 1e-5 and the matching scores of the matches both make within
    1e-5, or within the CPU's own spread under one-ulp moves of the input
    image where that is larger; and no untied flip: where the two sides'
    matches differ, an argmax that decides the match must differ too, by no
    more than the two log assignments differ (random weights leave the
    scores within rounding of a tie). The share of matched keypoints whose
    match agrees and the flips are printed. The same with cuDNN's TF32 on,
    printed as a control.
22. The training CLI on a seeded fern-shaped scene (phase 16's, no
    ``matches.npz``) with ``fern_ours.txt`` as it stands, phase 16's
    overrides, ``--matcher superglue --match_threshold 0.0`` and phase 21's
    weights in the cache, 20 steps: ``matcher_from_config`` must return the
    port's matcher on the card, the driver builds ``matches.npz`` over every
    pair it selects (pairs, seconds and matches a pair printed), at least
    one pair has matches, both PRD steps get a batch, K1 launched once a
    step and once a chunk of the three test views' renders; for three
    pairs, ``matches.npz`` as read back equal to the matcher rerun on the
    card on the pair's train views, and that rerun held to the CPU port by
    phase 21's limits.

23-26. The serving export, ``measure_roofline``, the native host library and
    data parallelism on NCCL (each phase function says what it holds).
27. The curriculum ablation at full width over a short horizon:
    ``scnerf_tpu_torch.scripts.ablation_curriculum.main`` at 120x160, 8x256,
    N_rand 1024, 64+64, its five rows (``gt_poses``, ``noisy_no_calib``,
    ``ie``, ``ie_od``, ``ie_od_prd``) at 300 steps each, so ``add_od`` 50 and
    ``add_prd`` 100, each evaluated on both test views. The analytic scene's
    16 GT views on the card against the CPU port (median |err| < 1e-6, max
    < 1e-4); the PRD row's ``matches.npz`` equal to the exact matches of the
    CPU-rendered scene; the initial camera errors the same in the three
    camera rows and within 1e-6 relative of the CPU port's from the same
    config; every metric finite; each row's last step's loss below its
    first; PRD on the steps the curriculum gives, each with a match batch,
    and valid matches on most of them (each PRD step's count printed); K1
    launched once a step and once a chunk of the two held-out renders in
    each row. Printed: each row's ms a step by
    CUDA events, plain and PRD apart, held-out PSNR and SSIM, camera errors
    before and after, the classical baselines, and the 3 dB gate, which is
    not held at 300 steps.
28. The four examples: ``distortion_discovery`` at its own 1,500 steps (its
    k error and its PRD must fall), ``calibration_ablation``,
    ``self_calibration_demo`` and ``from_scratch_calibration`` at 300 steps
    (finite outcomes, the loss falling in each arm); K1 launched once a
    train step and once a chunk of each held-out render; K1's first call at
    each shape the examples give it (1,024 train rays and the 8,192-ray
    chunks of a 100x100 render, the last edge-padded; 47 bins, 48 samples)
    held against its plain twin with phase 2's criterion, the render's
    samples at u = 1 (its deterministic u's last) to lie in the last bin on
    both sides; each example's outcomes, ms a step and seconds printed.

Each serving path, each of K3's and K4's own paths and each train path run
with the kernels' launch counts set to 0 just before and read just after. The
line before the last is one JSON object with the kernels' numbers, each with
the least time the card could take for its work (``bound_ms``: bytes over
3.35 TB/s or operations over the peak of the unit the kernel uses, float32
at 67 TFLOP/s or, for K3, three TF32 passes at 495 TFLOP/s; the larger), K1's
and K2's with their launches on the train paths too (K2's with its shape,
error, times and bound on the NeRF++ train step's inputs), the train
metrics (the driver's of phases 16-20 among them, K1's launches in phase 16
as ``driver_launches`` and in phase 19 as ``render_cli_launches``, K2's in
phase 18 as ``driver_launches`` and in phase 19 as ``render_cli_launches``;
K1's in phase 22 as ``superglue_driver_launches``), a ``matching`` record
(phase 21's pairs with their times, keypoints, waits, peak memory and
agreement, phase 22's pairs, seconds and matches) and the script's wall
time; the line before it is
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


def device_ms(fn, calls: int = TIMING_CALLS) -> float:
    """Device time of one call of ``fn``: the time of its kernels under
    ``torch.profiler`` over ``calls`` calls, over the count
    (``train/profiling.py:roofline_summary``)."""
    from torch.profiler import ProfilerActivity

    from scnerf_tpu_torch.train.profiling import profile_rows, roofline_summary, trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with trace(None, activities=[ProfilerActivity.CUDA], with_flops=False) as prof:
        for _ in range(calls):
            fn()
    cols, rows = profile_rows(prof)
    require(any(r[1] == "cuda" and r[3] > 0 for r in rows), "the profiler saw no device time")
    return roofline_summary(cols, rows, calls)["device_us_per_step"] / 1e3


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


def nerfpp_poses(n: int = PP_IMAGES, seed: int = 3):
    """bench.py's NeRF++ intrinsics (546x980, focal 580) and ``n`` seeded
    OpenCV c2w poses near the origin, each within 0.3 rad of looking down
    +z."""
    rng = np.random.RandomState(seed)
    K = np.array([[PP_FOCAL, 0, PP_W / 2, 0], [0, PP_FOCAL, PP_H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    E = np.tile(np.eye(4), (n, 1, 1))
    E[:, :3, :3] = rodrigues(axis, rng.rand(n) * 0.3)
    E[:, :3, 3] = rng.randn(n, 3) * 0.2
    return K, E


def nerfpp_camera(device, *, fisheye: bool = False):
    """bench.py's NeRF++ camera at its initial values: OpenCV (pixel offset
    0.5) at 546x980, focal 580, 12 seeded poses inside the unit sphere,
    multiplicative intrinsics noise; with ``fisheye`` its distortion variant
    (radial k = (-0.1, 0.03), tied ray noise)."""
    from scnerf_tpu_torch.camera import CameraConfig, OPENCV, init_camera

    K, E = nerfpp_poses()
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
                curriculum=None, group=None):
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
                           optimizer, with_prd=with_prd, group=group)
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
    """Device time of ``n`` steps by kernel group under ``torch.profiler``
    (read by ``train/profiling.py:profile_rows``), and the share of the
    window's host-clock time in which the device ran no kernel. Returns
    (state, {group: ms per step}, idle share, top kernels)."""
    from torch.profiler import ProfilerActivity

    from scnerf_tpu_torch.train.profiling import profile_rows, roofline_summary, trace

    torch.cuda.synchronize()
    with trace(None, activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               with_flops=False) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = run_step(state)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    cols, rows = profile_rows(prof)
    col = {c: i for i, c in enumerate(cols)}
    name, calls, self_us, dev_us = (col[c] for c in ("name", "calls", "self_device_us",
                                                      "device_us"))
    # A profiler range also shows as a device event spanning its kernels:
    # profile_rows keeps it as a host row, read below apart from the kernels.
    kernels = [(r[name], r[calls], r[self_us] / 1e3) for r in rows
               if r[col["device"]] == "cuda" and r[self_us] > 0]
    require(bool(kernels), "the profiler saw no device time in the train step")
    host = [r for r in rows if r[col["device"]] == "cpu"]
    # The host's calls into the CUDA runtime, a step: launches, copies and
    # waits for the device.
    runtime = {r[name]: r[calls] / n for r in host if r[name].startswith("cuda")}
    ops = sorted(((r[calls] / n, r[name]) for r in host if r[name].startswith("aten::")),
                 reverse=True)[:10]
    groups = {}
    for key, _, ms in kernels:
        lower = key.lower()
        group = next((g for g, subs in KERNEL_GROUPS if any(x in lower for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms / n
    top = sorted(kernels, key=lambda k: -k[2])[:8]
    launches = sum(count for _, count, _ in kernels) / n
    # The device time of the kernels launched inside each profiler range
    # (K2's backward is PyTorch ops: no kernel of its own names it).
    ranges = {r[name]: (r[calls] / n, r[dev_us] / 1e3 / n) for r in host
              if r[name] in PROFILE_RANGES}
    resamplers = [(key, count / n, ms / n) for key, count, ms in kernels
                  if "sample_pdf" in key.lower()]
    device_ms_a_step = roofline_summary(cols, rows, n)["device_us_per_step"] / 1e3
    return state, dict(groups=groups, top=top, ops=ops, kernels_a_step=launches,
                       runtime_a_step=runtime, window_ms_a_step=window_ms / n, ranges=ranges,
                       resamplers=resamplers, device_ms_a_step=device_ms_a_step)


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
                train_device_ms=profile["device_ms_a_step"],
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
                # torch.searchsorted on the rows K2 searches (the CDF without
                # its last entry), in turns with K2's forward: by events and
                # on the device.
                searched = cdf[:, :-1].contiguous()
                fns = {"kernel": lambda: pdf_cuda.sample_pdf_fwd(bins_d, weights, u,
                                                                 with_cdf=True),
                       "searchsorted": lambda: torch.searchsorted(searched, u, right=True,
                                                                  out_int32=True)}
                turns = in_turns(fns, TIMING_CALLS, K4_TIMING_TURNS)
                on_device = {name: device_ms(fn) for name, fn in fns.items()}
            # The forward with the CDF: reads bins, weights and u, writes the
            # depths, the counts and the CDF.
            bnd = bound(4 * (n * b + n * (b - 1) + 3 * n * s + n * b),
                        n * s * (math.ceil(math.log2(b)) + 6) + 3 * n * (b - 1))
            line += (f"; gradient into bins off in {frac:.2e} of entries; forward with CDF "
                     f"{fwd_ms:.4f} ms by events (plain twin {plain_ms:.4f}, bound "
                     f"{bnd['bound_ms']:.5f}), backward {bwd_ms:.4f} ms; in turns with "
                     f"torch.searchsorted on its rows ({n},{b - 1}) and queries ({n},{s}): "
                     f"events {turns['kernel']:.4f} against {turns['searchsorted']:.4f} ms, "
                     f"device {on_device['kernel']:.5f} against "
                     f"{on_device['searchsorted']:.5f} ms")
            record = dict(train_shape=[n, b, s], train_max_abs_err=mx, train_ms=fwd_ms,
                          train_plain_ms=plain_ms, train_bound_ms=bnd["bound_ms"],
                          train_backward_ms=bwd_ms, train_grad_share_off=frac,
                          train_turns_ms=turns["kernel"],
                          train_searchsorted_ms=turns["searchsorted"],
                          train_device_ms=on_device["kernel"],
                          train_searchsorted_device_ms=on_device["searchsorted"])
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


def smooth_texture(rng, h: int, w: int) -> np.ndarray:
    """An ``(h, w, 3)`` image in [0.05, 0.95]: four seeded sinusoids a
    channel."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([w, h])
            img[..., c] += np.sin(fx * xx + fy * yy + rng.uniform(0, 2 * np.pi))
    return 0.5 + 0.45 * img / 4


def fern_argv(root: str) -> list:
    """Phase 16's training flags: the fern config on the scene under
    ``root/fern``, logging under ``root/logs``, the whole camera and PRD
    from step 0."""
    return ["--config", FERN_CONFIG, "--datadir", os.path.join(root, "fern"),
            "--basedir", os.path.join(root, "logs"), "--add_ie", "0", "--add_od", "0",
            "--add_prd", "0", "--i_print", "10", "--i_weights", "30"]


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
    for i in range(FERN_VIEWS):
        png = to8b(smooth_texture(rng, FERN_H, FERN_W))
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

    argv = fern_argv(root)
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


# Phases 18-20: the NeRF++ training CLI and the render CLI on a seeded scene
# of Truck's shape (configs/tanks_and_temples/tat_training_Truck_ours.txt as
# it stands: fg and bg 8x256, multires 10/4, cascade 64,128, N_rand 256,
# chunk 4096, multiplicative intrinsics noise).
TRUCK_CONFIG = os.path.join("configs", "tanks_and_temples", "tat_training_Truck_ours.txt")
TRUCK_SCENE = "tat_training_Truck"  # the config's scene, joined to --datadir
TRUCK_EXP = "tat_training_Truck_ours"
TRUCK_HELD_OUT_SEED = 18
TRUCK_MATCH_POINTS = 200
TRUCK_STEPS = 60
TRUCK_TURN_STEPS = 10  # one PRD step in each span of ten (i_ray_dist_loss 10)
TRUCK_TURNS = 3
TRUCK_RAYS = 256
TRUCK_CPU_RAYS = 1024
TRUCK_PRD_INTRINSICS_MOVE = (1.0, -1.0, 0.5, -0.5)  # fx, fy, cx, cy in pixels (phase 20)


def write_truck_scene(root: str):
    """A seeded NeRF++ scene of Truck's shape at ``root``: a ``train/``
    split of phase 6's 12 poses and a ``validation/`` split of one more,
    each with 546x980 smooth seeded textures in ``rgb/`` (written by
    ``core/imaging.write_png``) and ``intrinsics/`` and ``pose/`` text
    files. Returns the train K and poses."""
    from scnerf_tpu_torch.core.imaging import to8b, write_png

    rng = np.random.RandomState(SEED + 18)
    K, train = nerfpp_poses()
    _, held = nerfpp_poses(1, seed=TRUCK_HELD_OUT_SEED)
    for split, poses in (("train", train), ("validation", held)):
        for sub in ("rgb", "intrinsics", "pose"):
            os.makedirs(os.path.join(root, split, sub))
        for i, c2w in enumerate(poses):
            write_png(os.path.join(root, split, "rgb", f"{i:05d}.png"),
                      to8b(smooth_texture(rng, PP_H, PP_W)))
            for sub, m in (("intrinsics", K), ("pose", c2w)):
                with open(os.path.join(root, split, sub, f"{i:05d}.txt"), "w") as f:
                    f.write(" ".join(repr(float(v)) for v in m.reshape(-1)))
    return K, train


def opencv_matches(K, poses, n_points: int, seed: int):
    """Matches between every pair of ``poses`` (c2w, OpenCV): seeded points
    in front of the cameras projected into both images (the keypoint of a
    point is the pixel whose centre, ``kp + 0.5``, sees it), those inside
    both kept."""
    from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches

    pts = np.random.RandomState(seed).uniform([-1.0, -0.6, 2.0], [1.0, 0.6, 4.0],
                                              (n_points, 3))
    kps, inside = [], []
    for c2w in poses:
        cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
        pix = cam @ K[:3, :3].T
        k = (pix[:, :2] / pix[:, 2:3] - 0.5).astype(np.float32)
        kps.append(k)
        inside.append((cam[:, 2] > 0) & (k[:, 0] >= 0) & (k[:, 0] < PP_W - 1)
                      & (k[:, 1] >= 0) & (k[:, 1] < PP_H - 1))
    cache = PrecomputedMatches()
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            keep = inside[i] & inside[j]
            cache.put(i, j, PairMatches(kps[i][keep], kps[j][keep]))
    return cache


def truck_argv(root: str) -> list:
    """Phase 18's training flags: the Truck config on the scene under
    ``root``, the whole camera and PRD from step 0, the hooks at 10, 30 and
    60 steps."""
    return ["--config", TRUCK_CONFIG, "--datadir", root, "--basedir", os.path.join(root, "logs"),
            "--ray_loss_type", "proj_ray_dist", "--add_ie", "0", "--add_od", "0",
            "--add_prd", "0", "--i_print", "10", "--i_weights", "30", "--i_testset", "60",
            "--i_img", "60", "--camera_log", "30"]


def finite_rows(expdir: str) -> list:
    rows = metric_rows(expdir)
    for row in rows:
        bad = [k for k, v in row.items() if isinstance(v, float) and not math.isfinite(v)]
        require(not bad, f"metrics.jsonl row at step {row['step']}: {bad} not finite")
    return rows


def phase_truck_driver(dev, card, root):
    """Phase 18: the NeRF++ training CLI on the card at Truck's full width
    on a seeded scene of Truck's shape: 60 steps with every hook, the
    loop's own pace, no wait on the device, a held-out render, SSIM and a
    checkpoint."""
    import io
    import warnings

    from scnerf_tpu_torch.cli import train as cli
    from scnerf_tpu_torch.core.imaging import read_png
    from scnerf_tpu_torch.matching.provider import pad_matches
    from scnerf_tpu_torch.metrics.ssim import ssim
    from scnerf_tpu_torch.train import checkpoint, driver, nerfpp_driver

    print("== phase 18: the NeRF++ training CLI at full Truck width on the card (seeded "
          "Truck-shaped scene)")
    started = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K, poses = write_truck_scene(os.path.join(root, TRUCK_SCENE))
    expdir = os.path.join(root, "logs", TRUCK_EXP)
    os.makedirs(expdir)
    matches = opencv_matches(K, poses, TRUCK_MATCH_POINTS, SEED + 18)
    matches.save(os.path.join(expdir, "matches.npz"))
    n_matches = [matches.get(i, j).kps0.shape[0] for i, j in matches.pairs()]
    print(f"  scene: {PP_IMAGES} train views and 1 validation view of {PP_H}x{PP_W}; "
          f"matches.npz: {len(n_matches)} pairs, {min(n_matches)}-{max(n_matches)} matches a "
          f"pair; written in {time.perf_counter() - started:.2f} s")

    argv = truck_argv(root)
    captured = []
    build = nerfpp_driver.build_nerfpp_experiment

    def capturing(*args, **kwargs):
        exp = build(*args, **kwargs)
        exp.step_fn = StepRecorder(exp.step_fn)
        exp.step_prd_fn = StepRecorder(exp.step_prd_fn)
        captured.append(exp)
        return exp

    nerfpp_driver.build_nerfpp_experiment = capturing
    try:
        torch.cuda.synchronize()
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + ["--steps", str(TRUCK_STEPS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        nerfpp_driver.build_nerfpp_experiment = build
    text = out.getvalue().strip()
    if text:
        print("  " + "\n  ".join(text.splitlines()))
    require(rc == 0, f"cli.train.main returned {rc}")
    exp = captured[-1]
    require(exp.device.type == dev.type, f"the CLI built its experiment on {exp.device}")
    held = nerfpp_driver._held_out_data(exp)
    n_held = held.H * held.W
    chunks = -(-n_held // exp.render_cfg.chunk)
    renders = min(2, held.poses.shape[0]) + 1  # i_testset's views and i_img's
    want = 2 * TRUCK_STEPS + 2 * renders * chunks
    print(f"  {TRUCK_STEPS} steps in {run_s:.2f} s; K2 launched {counts['K2']} times "
          f"({counts['K2 with CDF']} with the CDF): 2 x {TRUCK_STEPS} train steps + 2 x "
          f"{renders} held-out renders x {chunks} chunks = {want}")
    require(counts["K2"] == want and counts["K2 with CDF"] == TRUCK_STEPS,
            f"K2 launched {counts['K2']} times ({counts['K2 with CDF']} with the CDF), want "
            f"{want} ({TRUCK_STEPS})")
    require(counts["K1"] == 0, f"K1 launched {counts['K1']} times on the NeRF++ path")
    ckpts = checkpoint.list_checkpoint_steps(os.path.join(expdir, "ckpts"))
    require(ckpts == [30, 60], f"checkpoints after {TRUCK_STEPS} steps: {ckpts}")

    rows = finite_rows(expdir)
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    require([s for s, _ in losses] == list(range(10, TRUCK_STEPS + 1, 10)),
            f"logged steps {[s for s, _ in losses]}")
    hook = {k: v for r in rows if r["step"] == TRUCK_STEPS for k, v in r.items()}
    for k in ("test/psnr", "test/ssim", "test/prd", "camera/fx", "camera/fx_err"):
        require(k in hook and math.isfinite(hook[k]), f"hook metric {k}: {hook.get(k)}")
    require(hook.get("test/split") == "heldout", f"test split {hook.get('test/split')}")
    for name in ("val_rgb", "val_fg_rgb", "val_bg_rgb", "val_fg_depth"):
        png = read_png(os.path.join(expdir, "images", f"{name}_{TRUCK_STEPS:08d}.png"))
        require(png.shape == (PP_H, PP_W, 3), f"{name} panel {png.shape}")
    grid = read_png(os.path.join(expdir, "images", "camera_ray_o_noise_00000030.png"))
    require(grid.shape == tuple(exp.state.params["camera"].ray_o_grid.shape),
            f"camera-log PNG {grid.shape}")

    records = {"plain": [], "prd": []}
    prd_matches = []
    for recorder, kind in ((exp.step_fn, "plain"), (exp.step_prd_fn, "prd")):
        for step, ms, m in recorder.read():
            if step > 2:
                records[kind].append(ms)
            if kind == "prd":
                prd_matches.append(m["prd_matches"])
    require(len(prd_matches) == TRUCK_STEPS // TRUCK_TURN_STEPS and prd_matches[0] > 0,
            f"prd_matches on the PRD steps: {prd_matches}")
    step_ms = {kind: percentiles(ms) for kind, ms in records.items()}
    print(f"  logged losses {[(s, round(v, 5)) for s, v in losses]}; hooks at step "
          f"{TRUCK_STEPS}: " + ", ".join(f"{k}={hook[k]:.5g}" for k in sorted(hook)
                                         if k.startswith("test/") and k != "test/split")
          + "; panels and camera-log PNGs read back")
    print(f"  each step by CUDA events but the first two ({card}): plain {step_ms['plain']}, "
          f"PRD {step_ms['prd']}; prd_matches {prd_matches}")

    # The loop between its hooks never waits for the device.
    exp.step_fn, exp.step_prd_fn = exp.step_fn.fn, exp.step_prd_fn.fn
    log = exp.cfg.logging
    log.i_print = log.i_weights = log.i_testset = log.i_img = log.camera_log = 10**9
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            nerfpp_driver.run_nerfpp_training(exp.cfg, expdir, exp.state.step + TRUCK_TURN_STEPS,
                                              exp=exp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    sites = sorted({f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    print(f"  calls that wait for the device in {TRUCK_TURN_STEPS} loop steps (one with PRD): "
          f"{sites or 'none'}")
    require(not sites, f"the NeRF++ loop waits for the device at {sites}")

    # The loop against the same step functions on one ready device batch,
    # in turns: the gap is the host loop's own cost (the draws, the gather,
    # the copy).
    ready = nerfpp_driver.nerfpp_sample_batch(exp)
    i, j = matches.pairs()[0]
    kps0, kps1, mask = pad_matches(matches.get(i, j), exp.cfg.camera.match_num)
    ready_prd = dict(ready, **driver.to_device(
        {"kps0": kps0, "kps1": kps1, "kp_mask": mask,
         "pair_idx": np.array([i, j], np.int64)}, dev))
    seed = exp.cfg.logging.seed

    def loop_span():
        nerfpp_driver.run_nerfpp_training(exp.cfg, expdir, exp.state.step + TRUCK_TURN_STEPS,
                                          exp=exp)

    def ready_span():
        for _ in range(TRUCK_TURN_STEPS):
            it = exp.state.step
            gen = driver.step_generator(seed, it, dev)
            if it % TRUCK_TURN_STEPS == 0:
                exp.state, _ = exp.step_prd_fn(exp.state, ready_prd, gen)
            else:
                exp.state, _ = exp.step_fn(exp.state, ready, gen)

    turns = {"loop": [], "ready": []}
    for _ in range(TRUCK_TURNS):
        for name, span in (("loop", loop_span), ("ready", ready_span)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            span()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3 / TRUCK_TURN_STEPS)
    loop_ms = statistics.median(turns["loop"])
    ready_ms = statistics.median(turns["ready"])
    t0 = time.perf_counter()
    for _ in range(20):
        nerfpp_driver._host_batch(exp)
    draw_ms = (time.perf_counter() - t0) * 1e3 / 20
    rays_per_s = TRUCK_RAYS / loop_ms * 1e3
    print(f"  spans of {TRUCK_TURN_STEPS} steps (one with PRD), {TRUCK_TURNS} turns each, host "
          f"clock to a synchronize ({card}): the loop {loop_ms:.3f} ms a step "
          f"({rays_per_s:.1f} train rays/s), the same steps on one ready batch {ready_ms:.3f} "
          f"ms; the loop's own cost {loop_ms - ready_ms:.3f} ms a step; the host batch's draws "
          f"alone (a pixel choice without replacement among {PP_H * PP_W}) {draw_ms:.3f} ms "
          f"of host time (turns {turns})")

    # One held-out view: render, SSIM, then a checkpoint.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = nerfpp_driver.render_nerfpp_image(exp, c2w=held.poses[0], K=held.intrinsics[0],
                                            hw=(held.H, held.W))  # ends in the copies
    render_s = time.perf_counter() - t0
    for k, v in out.items():
        require(bool(np.isfinite(v).all()) and v.shape[:2] == (PP_H, PP_W),
                f"held-out {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    rgb = torch.from_numpy(out["rgb"]).to(dev)
    target = torch.from_numpy(held.images[0]).to(dev)
    ssim_ms = per_call_ms(lambda: ssim(rgb, target), calls=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save_checkpoint(os.path.join(root, "truck_ckpts"), exp.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = os.path.getsize(path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    seconds = time.perf_counter() - started
    print(f"  one {PP_H}x{PP_W} held-out view: {render_s:.3f} s ({n_held / render_s:.1f} rays/s, "
          f"{chunks} chunks), SSIM {ssim_ms:.3f} ms by CUDA events; checkpoint {ckpt_bytes} "
          f"bytes, saved in {save_ms:.1f} ms; peak memory {peak_gib:.3f} GiB; phase "
          f"{seconds:.1f} s ({card})")
    record = dict(
        truck_launches=counts["K2"], truck_cdf_launches=counts["K2 with CDF"],
        truck_run_s=run_s, truck_step_ms=step_ms, truck_prd_matches=prd_matches,
        truck_loop_ms=loop_ms, truck_ready_ms=ready_ms, truck_draw_ms=draw_ms,
        truck_rays_per_s=rays_per_s, truck_render_s=render_s,
        truck_render_rays_per_s=n_held / render_s, truck_ssim_ms=ssim_ms,
        truck_ckpt_bytes=ckpt_bytes, truck_ckpt_save_ms=save_ms, truck_peak_gib=peak_gib,
        truck_phase_s=seconds)
    return record, exp, out


def phase_render_cli(dev, card, root, fern_exp):
    """Phase 19: the render CLI on the card, on phase 18's NeRF++ experiment
    and on phase 16's fern experiment, the ``--render_only`` dispatch and
    the ``i_video`` hook's render."""
    import io

    from scnerf_tpu_torch.cli import render as rcli
    from scnerf_tpu_torch.cli import train as tcli
    from scnerf_tpu_torch.core.imaging import read_png
    from scnerf_tpu_torch.train import driver

    print("== phase 19: the render CLI on the card")
    started = time.perf_counter()

    def run(main, argv, what):
        torch.cuda.synchronize()
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        text = out.getvalue()
        print(f"  {what} ({seconds:.2f} s):\n    " + "\n    ".join(text.strip().splitlines()))
        require(rc == 0, f"{what} returned {rc}")
        evals = [line for line in text.splitlines() if line.startswith("[eval]")]
        require(len(evals) == 1, f"{what}: no single [eval] line")
        return text, launch_counts()

    text, counts = run(rcli.main, truck_argv(root) + ["--split", "test", "--max_views", "1"],
                       "cli.render on the NeRF++ experiment, --split test --max_views 1")
    require(f"[render] restored step {TRUCK_STEPS} from" in text, "the NeRF++ render did not "
            f"restore step {TRUCK_STEPS}")
    chunks = -(-PP_H * PP_W // PP_BATCH)
    want = 2 * 2 * chunks  # the evaluation's render and the dump's, fg and bg a chunk
    print(f"  K2 launched {counts['K2']} times: 2 renders x {chunks} chunks x 2 = {want}")
    require(counts["K2"] == want and counts["K1"] == 0,
            f"K2 launched {counts['K2']} times (K1 {counts['K1']}), want {want}")
    out_dir = os.path.join(root, "logs", TRUCK_EXP, "render_test")
    for name in ("000.png", "000_fg.png", "000_bg.png", "000_depth.png"):
        png = read_png(os.path.join(out_dir, name))
        require(png.shape == (PP_H, PP_W, 3), f"{name}: {png.shape}")
    with open(os.path.join(out_dir, f"{TRUCK_EXP}.txt")) as f:
        summary = f.read().split()
    require(summary[0::2] == ["psnr", "ssim"] and all(math.isfinite(float(v))
                                                      for v in summary[1::2]),
            f"summary {summary}")
    k2 = counts["K2"]

    fern_chunks = -(-FERN_H * FERN_W // fern_exp.render_cfg.chunk)
    k1 = 0
    for main, extra, what in (
            (rcli.main, ["--split", "test", "--max_views", "1"],
             "cli.render on the fern experiment, --split test --max_views 1"),
            (tcli.main, ["--render_only", "True", "--render_test", "True", "--max_views", "1"],
             "cli.train --render_only True --render_test True on the fern experiment")):
        text, counts = run(main, fern_argv(root) + extra, what)
        require(f"[render] restored step {DRIVER_RESUME_STEPS} from" in text,
                f"{what} did not restore step {DRIVER_RESUME_STEPS}")
        require(counts["K1"] == 2 * fern_chunks and counts["K2"] == 0,
                f"{what}: K1 launched {counts['K1']} times, want 2 x {fern_chunks}")
        k1 += counts["K1"]
    png = read_png(os.path.join(root, "logs", "fern_ours", "render_test", "000.png"))
    require(png.shape == (FERN_H, FERN_W, 3), f"fern render {png.shape}")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    video = driver.render_training_video(fern_exp, fern_exp.state.step,
                                         out_dir=os.path.join(root, "video"), max_frames=3)
    video_s = time.perf_counter() - t0
    counts = launch_counts()
    require(counts["K1"] == 3 * fern_chunks, f"the video: K1 launched {counts['K1']} times, "
                                             f"want 3 x {fern_chunks}")
    require(os.path.exists(video), f"no video at {video}")
    if video.endswith(".npz"):
        with np.load(video) as npz:
            shape = npz["frames"].shape
        require(shape == (3, FERN_H, FERN_W, 3), f"video frames {shape}")
    k1 += counts["K1"]
    seconds = time.perf_counter() - started
    print(f"  render_training_video: {video} in {video_s:.2f} s; K1 launched {k1} times: "
          f"2 x 2 test-view renders x {fern_chunks} chunks + 3 frames x {fern_chunks} chunks; "
          f"phase {seconds:.1f} s ({card})")
    return dict(render_cli_k2_launches=k2, render_cli_k1_launches=k1, render_cli_video=video,
                render_cli_phase_s=seconds)


def ulp_moved(cache, direction: float):
    """A copy of a match cache with every keypoint moved by one float32
    ulp towards ``direction``."""
    from scnerf_tpu_torch.matching.provider import PairMatches, PrecomputedMatches

    moved = PrecomputedMatches()
    for i, j in cache.pairs():
        m = cache.get(i, j)
        moved.put(i, j, PairMatches(*(np.nextafter(k, np.float32(direction))
                                      for k in (m.kps0, m.kps1))))
    return moved


def lpips_test_weights(path: str) -> None:
    """Seeded random VGG16 and head weights in ``metrics/lpips.py``'s file
    layout (He-scaled convs, so the activations stay O(1)), saved at
    ``path``: no VGG weights ship with the repository."""
    from scnerf_tpu_torch.metrics.lpips import _VGG16_PLAN

    rng = np.random.RandomState(SEED + 20)
    w, cin, ci, tap = {}, 3, 0, 0
    for item in _VGG16_PLAN:
        if item == "tap":
            w[f"lin{tap}_w"] = rng.uniform(0.0, 1.0, cin).astype(np.float32)
            tap += 1
        elif item != "M":
            w[f"conv{ci}_w"] = (rng.randn(3, 3, cin, item) * np.sqrt(2.0 / (9 * cin))).astype(
                np.float32)
            w[f"conv{ci}_b"] = (rng.randn(item) * 0.01).astype(np.float32)
            cin, ci = item, ci + 1
    w["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    w["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    np.savez(path, **w)


def phase_truck_cpu_agreement(exp, card_out, root):
    """Phase 20: phase 18's trained NeRF++ experiment carried to the CPU
    port: the held-out render, SSIM, PRD evaluation and LPIPS on both
    devices."""
    from scnerf_tpu_torch import bridge
    from scnerf_tpu_torch.metrics import lpips as lpips_module
    from scnerf_tpu_torch.metrics.ssim import ssim
    from scnerf_tpu_torch.train import nerfpp_driver
    from scnerf_tpu_torch.train.step import create_train_state

    print("== phase 20: the NeRF++ evaluation on the card against the CPU port")
    started = time.perf_counter()
    cpu = nerfpp_driver.build_nerfpp_experiment(exp.cfg, None, device="cpu")
    tree = bridge.train_params_to_numpy(exp.state.params)
    tree["camera"]["config"] = exp.state.params["camera"].config
    cpu.state = create_train_state(bridge.train_params_to_torch(tree, device="cpu"),
                                   cpu.optimizer)
    cpu.pair_list, cpu.match_cache = exp.pair_list, exp.match_cache
    held = nerfpp_driver._held_out_data(exp)
    view = dict(c2w=held.poses[0], K=held.intrinsics[0], hw=(held.H, held.W))

    rng = np.random.default_rng(SEED + 20)
    pick = rng.choice(PP_H * PP_W, TRUCK_CPU_RAYS, replace=False)
    px = torch.from_numpy((pick % PP_W).astype(np.float32))
    py = torch.from_numpy((pick // PP_W).astype(np.float32))
    cpu_maps = nerfpp_driver.render_nerfpp_pixels(cpu, px, py, **view)
    errs = {}
    for k in ("rgb", "fg_rgb", "bg_rgb"):
        err = np.abs(cpu_maps[k].numpy() - card_out[k].reshape(-1, 3)[pick])
        errs[k] = (float(np.median(err)), float(err.max()))

    target = held.images[0]
    card_ssim = float(ssim(torch.from_numpy(card_out["rgb"]).to(exp.device),
                           torch.from_numpy(target).to(exp.device)))
    cpu_ssim = float(ssim(torch.from_numpy(card_out["rgb"]), torch.from_numpy(target)))

    # PRD at the trained camera; where its distances read float32's
    # rounding, with the learned intrinsics moved by a pixel or so on both
    # devices, as phase 17 does. Printed beside it: the CPU's own spread, its
    # largest change when the keypoints, or the camera's initial intrinsics,
    # or its initial poses move by one float32 ulp either way (the closest
    # points of two rays amplify rounding by the inverse square of their
    # angle).
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def cpu_prd():
        return nerfpp_driver.evaluate_nerfpp_prd(cpu).get("prd", float("nan"))

    prd = [nerfpp_driver.evaluate_nerfpp_prd(exp).get("prd", float("nan")), cpu_prd()]
    prd_at = "at the trained camera"
    if not prd[1] >= 1e-3:
        for e in (exp, cpu):
            with torch.no_grad():
                init = e.state.params["camera"].intrinsics_init
                init.add_(torch.tensor(TRUCK_PRD_INTRINSICS_MOVE, device=init.device))
        prd = [nerfpp_driver.evaluate_nerfpp_prd(exp).get("prd", float("nan")), cpu_prd()]
        prd_at = f"with the intrinsics moved by {TRUCK_PRD_INTRINSICS_MOVE} px"
    camera = cpu.state.params["camera"]
    spread = 0.0
    for direction in (np.inf, -np.inf):
        cpu.match_cache = ulp_moved(exp.match_cache, direction)
        spread = max(spread, rel(cpu_prd(), prd[1]))
        cpu.match_cache = exp.match_cache
        for name in ("intrinsics_init", "extrinsics_init"):
            leaf = getattr(camera, name)
            saved = leaf.clone()
            with torch.no_grad():
                leaf.copy_(torch.nextafter(leaf, torch.full_like(leaf, direction)))
            spread = max(spread, rel(cpu_prd(), prd[1]))
            with torch.no_grad():
                leaf.copy_(saved)

    path = os.path.join(root, "lpips_seeded.npz")
    lpips_test_weights(path)
    rgb_card = torch.from_numpy(card_out["rgb"]).to(exp.device)
    target_card = torch.from_numpy(target).to(exp.device)
    w_card = lpips_module.load_weights(path, device=exp.device)
    card_lpips = float(lpips_module.lpips(rgb_card, target_card, w_card))
    lpips_ms = per_call_ms(lambda: lpips_module.lpips(rgb_card, target_card, w_card), calls=3,
                           repeats=3)
    cpu_lpips = float(lpips_module.lpips(torch.from_numpy(card_out["rgb"]),
                                         torch.from_numpy(target),
                                         lpips_module.load_weights(path, device="cpu")))
    # The control: LPIPS with cuDNN's TF32 on.
    fp32 = lpips_module.fp32
    lpips_module.fp32 = tf32_on
    try:
        tf32_lpips = float(lpips_module.lpips(rgb_card, target_card, w_card))
    finally:
        lpips_module.fp32 = fp32
    print("  held-out view through the learned camera at its c2w, "
          f"{TRUCK_CPU_RAYS} seeded pixels: " + ", ".join(
              f"{k} median|err|={m:.3e} max|err|={x:.3e}" for k, (m, x) in errs.items()))
    print(f"  ssim card {card_ssim:.8f} cpu {cpu_ssim:.8f} (|diff| "
          f"{abs(card_ssim - cpu_ssim):.3e}); evaluate_nerfpp_prd {prd_at} card {prd[0]:.8g} "
          f"cpu {prd[1]:.8g} (rel {rel(*prd):.3e}; the CPU's own one-ulp spread {spread:.3e})")
    print(f"  lpips (seeded random VGG16 weights) card {card_lpips:.8g} cpu {cpu_lpips:.8g} "
          f"(rel {rel(card_lpips, cpu_lpips):.3e}), {lpips_ms:.3f} ms a call on the card by "
          f"events; control with cuDNN's TF32 on: {tf32_lpips:.8g} (rel "
          f"{rel(tf32_lpips, cpu_lpips):.3e}, limit 1e-4: "
          f"{'broken' if rel(tf32_lpips, cpu_lpips) >= 1e-4 else 'kept'}); "
          f"{time.perf_counter() - started:.1f} s")
    for k, (med, worst) in errs.items():
        require(med < 1e-5 and worst < 1e-3, f"held-out {k} median|err|={med:.3e} "
                                             f"max|err|={worst:.3e}")
    require(abs(card_ssim - cpu_ssim) < 1e-6, f"ssim card {card_ssim} cpu {cpu_ssim}")
    require(all(math.isfinite(v) for v in prd), f"evaluate_nerfpp_prd {prd_at}: {prd}")
    require(rel(*prd) < 1e-5, f"evaluate_nerfpp_prd {prd_at}: card {prd[0]} cpu {prd[1]} (rel "
                              f"{rel(*prd)})")
    require(rel(card_lpips, cpu_lpips) < 1e-4, f"lpips card {card_lpips} cpu {cpu_lpips}")
    return dict(truck_cpu_errs=errs, truck_cpu_ssim_diff=abs(card_ssim - cpu_ssim),
                truck_cpu_prd=prd, truck_cpu_prd_at=prd_at, truck_cpu_prd_rel=rel(*prd),
                truck_cpu_prd_spread=spread,
                truck_lpips=[card_lpips, cpu_lpips], truck_lpips_ms=lpips_ms,
                truck_lpips_rel=rel(card_lpips, cpu_lpips),
                truck_lpips_tf32_rel=rel(tf32_lpips, cpu_lpips))


# Phases 21-22: the SuperGlue matcher. The published architecture, as
# transformers' SuperGlueConfig and SuperPointConfig build it (the layout of
# magic-leap-community/superglue_outdoor's config.json); CameraFlags' knobs
# go onto it when the matcher loads it.
SG_CONFIG = {
    "keypoint_detector_config": {
        "model_type": "superpoint", "encoder_hidden_sizes": [64, 64, 128, 128],
        "decoder_hidden_size": 256, "keypoint_decoder_dim": 65, "descriptor_decoder_dim": 256,
        "keypoint_threshold": 0.005, "max_keypoints": -1, "nms_radius": 4,
        "border_removal_distance": 4},
    "hidden_size": 256, "keypoint_encoder_sizes": [32, 64, 128, 256],
    "gnn_layers_types": ["self", "cross"] * 9, "num_attention_heads": 4,
    "sinkhorn_iterations": 100, "matching_threshold": 0.0,
}
SG_PARAMETERS = 13_324_162
SG_PAIRS = (("fern", 378, 504), ("Truck", 546, 980), ("LLFF full", 756, 1008))
SG_SHIFT = 16  # pixels between a pair's two crops
SG_WARMUP, SG_TIMED = 2, 5
SG_COMMIT = "0" * 40  # the snapshot the hub cache's refs/main names
# Card against the CPU port: shares at least, differences at most
# (``log_assignment`` relative, entry by entry; ``untied_flips`` a count).
SG_LIMITS = {"keypoints_shared": 0.99, "score": 1e-5, "descriptor": 1e-4,
             "log_assignment": 1e-5, "matching_score": 1e-5, "untied_flips": 0}
SG_SHARES = ("keypoints_shared",)
SG_EXACT = ("untied_flips",)  # never widened by the CPU's spread
SG_CPU_PAIRS = 3  # phase 22's pairs held to the CPU port
SG_DRIVER_STEPS = 20


def seeded_superglue_state(config: dict, seed: int) -> dict:
    """Random weights of ``config`` from ``seed``: transformers'
    initialisation, but the detector's convolutions at He's fan-in scale (at
    transformers' 0.02 eight convolutions leave every score at 1/65, and the
    keypoints are a tie-break)."""
    from scnerf_tpu_torch.matching.superglue import SuperGlue
    from scnerf_tpu_torch.matching.superglue_hf import init_weights

    gen = torch.Generator().manual_seed(seed)
    model = init_weights(SuperGlue(config), gen)
    with torch.no_grad():
        for m in model.keypoint_detector.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=gen)
    params = sum(p.numel() for p in model.parameters())
    require(params == SG_PARAMETERS, f"SuperGlue has {params} parameters, want {SG_PARAMETERS}")
    return model.state_dict()


def textured_pair(rng, h: int, w: int):
    """Two ``(h, w, 3)`` float32 crops of one seeded texture (smooth waves and
    pixel noise), the second ``SG_SHIFT`` pixels to the right."""
    base = np.clip(smooth_texture(rng, h, w + SG_SHIFT) + 0.15 * rng.randn(h, w + SG_SHIFT, 3),
                   0.0, 1.0).astype(np.float32)
    return base[:, :w], base[:, SG_SHIFT:]


def matcher_outputs(model, pixels, timed: bool = False):
    """SuperPoint, the GNN and Sinkhorn with the extraction on ``pixels``:
    (the outputs, the same as numpy without the batch axis, and with
    ``timed`` each stage's ms by CUDA events)."""
    h, w = pixels.shape[-2:]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else []
    mark = (lambda i: events[i].record()) if timed else (lambda i: None)
    mark(0)
    kp, sc, desc, mask = model.detect(pixels)
    mark(1)
    pair = model.score(kp, sc, desc, mask, h, w)
    mark(2)
    z, matches, mscores = model.assign(pair)
    mark(3)
    out = {"keypoints": kp, "scores": sc, "descriptors": desc, "mask": mask,
           "log_assignment": z, "matches": matches, "matching_scores": mscores}
    ms = {}
    if timed:
        events[3].synchronize()
        ms = {name: events[i].elapsed_time(events[i + 1])
              for i, name in enumerate(("superpoint", "gnn", "sinkhorn"))}
    return out, {k: v.detach().cpu().numpy()[0] for k, v in out.items()}, ms


def match_agreement(a: dict, b: dict, height: int, width: int) -> dict:
    """``a`` against ``b`` (one pair's outputs as numpy), on the keypoints
    both found (by pixel): the least share of an image's keypoints found by
    both; the largest score and descriptor differences on them; the largest
    relative difference of the log assignment between them (Sinkhorn's
    output without the dustbins) and ``delta``, its largest absolute one;
    ``matched_agree``, the least share of the keypoints matched on either
    side whose match (the other image's keypoint by pixel, or none) is the
    same; ``flips``, the keypoints whose match differs, and
    ``untied_flips``, those of them that the scores do not explain; and the
    largest matching-score difference where the match is the same.

    A match is the mutual argmax of a row and a column of the log
    assignment. A flip is tied when some argmax that decides it (the
    keypoint's row and the columns of both sides' row argmaxes) differs
    between ``a`` and ``b``, and ``b``'s scores of the two choices lie
    within ``2 delta``, the most that two choices can swap by when no entry
    differs by more than ``delta``. A flip with no differing argmax, or one
    past that margin, is untied: the extraction did not follow the scores.
    """
    index = []
    for out in (a, b):
        rows = []
        for k in range(2):
            valid = out["mask"][k] > 0
            pix = np.rint(out["keypoints"][k][valid] * [width, height]).astype(np.int64)
            rows.append({tuple(p): i for i, p in enumerate(pix)})
        index.append(rows)
    res = {"keypoints_shared": 1.0, "score": 0.0, "descriptor": 0.0, "log_assignment": 0.0,
           "delta": 0.0, "matched_agree": 1.0, "flips": 0, "untied_flips": 0,
           "matching_score": 0.0,
           "matches": [int((out["matches"][0] > -1).sum()) for out in (a, b)]}
    sa, sb = [], []
    for k in range(2):
        ia, ib = index[0][k], index[1][k]
        shared = [p for p in ia if p in ib]
        res["keypoints_shared"] = min(res["keypoints_shared"],
                                      len(shared) / max(len(ia), len(ib), 1))
        sa.append(np.array([ia[p] for p in shared], np.int64))
        sb.append(np.array([ib[p] for p in shared], np.int64))
        if shared:
            res["score"] = max(res["score"], float(np.abs(
                a["scores"][k][sa[k]] - b["scores"][k][sb[k]]).max()))
            res["descriptor"] = max(res["descriptor"], float(np.abs(
                a["descriptors"][k][sa[k]] - b["descriptors"][k][sb[k]]).max()))
    if not (len(sa[0]) and len(sa[1])):
        return res
    za = a["log_assignment"][np.ix_(sa[0], sa[1])].astype(np.float64)
    zb = b["log_assignment"][np.ix_(sb[0], sb[1])].astype(np.float64)
    diff = np.abs(za - zb)
    res["delta"] = float(diff.max())
    res["log_assignment"] = float((diff / np.maximum(np.abs(zb), 1e-30)).max())
    tie = 2.0 * res["delta"]
    for k in range(2):
        # Rows are image k's keypoints, columns the other image's, in the
        # order of the shared keypoints.
        ya, yb = (za, zb) if k == 0 else (za.T, zb.T)
        ra, rb = ya.argmax(1), yb.argmax(1)
        ca, cb = ya.argmax(0), yb.argmax(0)
        at_a = {int(n): m for m, n in enumerate(sa[1 - k])}
        at_b = {int(n): m for m, n in enumerate(sb[1 - k])}
        # -1: unmatched; -2: matched to a keypoint the other side lacks.
        ma = np.array([at_a.get(int(x), -2) if x >= 0 else -1 for x in a["matches"][k][sa[k]]])
        mb = np.array([at_b.get(int(x), -2) if x >= 0 else -1 for x in b["matches"][k][sb[k]]])
        matched = (ma != -1) | (mb != -1)
        same = ma == mb
        if matched.any():
            res["matched_agree"] = min(res["matched_agree"], float(same[matched].mean()))
        both = same & (ma >= 0)
        if both.any():
            res["matching_score"] = max(res["matching_score"], float(np.abs(
                a["matching_scores"][k][sa[k][both]] - b["matching_scores"][k][sb[k][both]]).max()))
        for p in np.flatnonzero(~same):
            res["flips"] += 1
            decided = [(yb[p, ra[p]], yb[p, rb[p]])] if ra[p] != rb[p] else []
            decided += [(yb[cb[q], q], yb[ca[q], q]) for q in {ra[p], rb[p]} if ca[q] != cb[q]]
            if not decided or any(abs(x - y) > tie for x, y in decided):
                res["untied_flips"] += 1
    return res


def over_sg_limits(got: dict, limits: dict) -> list:
    return [k for k in SG_LIMITS if (got[k] < limits[k] if k in SG_SHARES else got[k] > limits[k])]


def sg_limits(spread: dict) -> dict:
    """:data:`SG_LIMITS`, each widened to the CPU's one-ulp ``spread`` where
    that is wider, but :data:`SG_EXACT`."""
    return {k: v if k in SG_EXACT else (min if k in SG_SHARES else max)(v, spread[k])
            for k, v in SG_LIMITS.items()}


def hold_to_cpu(card_np, cpu_model, pixels, rng, what):
    """The card's outputs against the CPU port's on the same pixels, within
    :data:`SG_LIMITS` or, where one of them is tighter than float32's
    conditioning, within the CPU's own spread under one-ulp moves of the
    input image (:func:`sg_limits`). Returns (agreement, spread, limits,
    the CPU's outputs)."""
    from scnerf_tpu_torch.serve import fp32_inference

    host = pixels.cpu()
    with fp32_inference():
        _, cpu_np, _ = matcher_outputs(cpu_model, host)
        moved = torch.from_numpy(one_ulp_moves(rng, host.numpy()))
        _, moved_np, _ = matcher_outputs(cpu_model, moved)
    height, width = pixels.shape[-2:]
    got = match_agreement(card_np, cpu_np, height, width)
    spread = match_agreement(moved_np, cpu_np, height, width)
    limits = sg_limits(spread)
    print(f"  {what}: card vs CPU {fmt_sg(got)}; the CPU's one-ulp spread {fmt_sg(spread)}")
    bad = over_sg_limits(got, limits)
    require(not bad, f"{what}: {bad} beyond {limits}")
    return got, spread, limits, cpu_np


def fmt_sg(r: dict) -> str:
    return (f"keypoints shared {r['keypoints_shared']:.4f}, |d score| {r['score']:.3g}, "
            f"|d descriptor| {r['descriptor']:.3g}, log assignment rel {r['log_assignment']:.3g} "
            f"(|d| {r['delta']:.3g}), matched keypoints agreeing {r['matched_agree']:.4f}, "
            f"flips {r['flips']} (untied {r['untied_flips']}), |d matching score| "
            f"{r['matching_score']:.3g}, mutual matches {r['matches']}")


def write_hub_weights(cache: str, repo_id: str, config: dict, state: dict) -> str:
    """``config`` and ``state`` as the hub cache holds ``repo_id`` (its
    ``refs/main`` naming one snapshot): ``config.json``,
    ``preprocessor_config.json`` with the processor's defaults and
    ``model.safetensors``, float32 and int64 tensors only (the inverse of the
    port's ``read_safetensors``: an 8-byte little-endian header length, the
    JSON header padded to 8 bytes, the raw buffers). Returns the snapshot."""
    from scnerf_tpu_torch.matching.superglue_hf import PROCESSOR_DEFAULTS

    repo = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", SG_COMMIT)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(SG_COMMIT)
    for name, doc in (("config.json", {"model_type": "superglue", **config}),
                      ("preprocessor_config.json", PROCESSOR_DEFAULTS)):
        with open(os.path.join(snapshot, name), "w") as f:
            json.dump(doc, f)
    header, blobs = {}, []
    for name, tensor in state.items():
        array = tensor.detach().cpu().contiguous().numpy()
        blob = array.astype(array.dtype.newbyteorder("<")).tobytes()
        offset = sum(len(b) for b in blobs)
        header[name] = {"dtype": {torch.float32: "F32", torch.int64: "I64"}[tensor.dtype],
                        "shape": list(tensor.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(os.path.join(snapshot, "model.safetensors"), "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + b"".join(blobs))
    return snapshot


def phase_superglue(dev, card, root):
    """Phase 21: SuperPoint + SuperGlue at the published width on the card,
    loaded through ``matcher_from_config`` from a hub cache the phase
    writes; per pair its time and split, keypoints, waits and peak memory,
    and the card against the CPU port."""
    import warnings

    from scnerf_tpu_torch.core.config import CameraFlags
    from scnerf_tpu_torch.matching.provider import matcher_from_config
    from scnerf_tpu_torch.matching.superglue_hf import HUB_IDS, HFSuperGlueMatcher
    from scnerf_tpu_torch.serve import fp32, fp32_inference

    print("== phase 21: SuperPoint + SuperGlue at the published width on the card")
    started = time.perf_counter()
    state = seeded_superglue_state(SG_CONFIG, SEED + 21)
    cam = CameraFlags(matcher="superglue", match_threshold=0.0)
    snapshot = write_hub_weights(os.environ["HF_HUB_CACHE"], HUB_IDS[cam.superglue_weight],
                                 SG_CONFIG, state)
    matcher = matcher_from_config(cam, dev)
    require(isinstance(matcher, HFSuperGlueMatcher) and matcher.device == dev,
            f"matcher_from_config returned {type(matcher).__name__} on "
            f"{getattr(matcher, 'device', None)}")
    loaded = matcher.model.state_dict()
    require(all(torch.equal(loaded[k].cpu(), v) for k, v in state.items()),
            "the matcher's weights are not the ones the phase wrote")
    model = matcher.model
    detector = model.keypoint_detector.config
    require((detector["max_keypoints"], detector["keypoint_threshold"], detector["nms_radius"],
             model.config["sinkhorn_iterations"]) == (cam.max_keypoints, cam.keypoint_threshold,
                                                      cam.nms_radius, cam.sinkhorn_iterations),
            f"the knobs did not reach the model: {detector}, {model.config}")
    cpu = HFSuperGlueMatcher(pretrained=snapshot, device="cpu", nms_radius=cam.nms_radius,
                             keypoint_threshold=cam.keypoint_threshold,
                             max_keypoints=cam.max_keypoints,
                             sinkhorn_iterations=cam.sinkhorn_iterations, match_threshold=0.0)
    print(f"  {SG_PARAMETERS:,} parameters of seeded weights written to {snapshot} and loaded by "
          f"matcher_from_config(matcher=superglue) on {dev}: max_keypoints {cam.max_keypoints}, "
          f"nms_radius {cam.nms_radius}, keypoint_threshold {cam.keypoint_threshold}, "
          f"sinkhorn_iterations {cam.sinkhorn_iterations}, match_threshold 0.0")

    rng = np.random.RandomState(SEED + 21)
    ulp_rng = np.random.default_rng(SEED + 21)
    pairs = {}
    for name, h, w in SG_PAIRS:
        img0, img1 = textured_pair(rng, h, w)
        for _ in range(SG_WARMUP):
            matcher.match(img0, img1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prep_ms, total_ms, post_ms, stages = [], [], [], []
        for _ in range(SG_TIMED):
            t0 = time.perf_counter()
            pixels = matcher.prepare(img0, img1)
            t1 = time.perf_counter()
            with fp32_inference():
                out, card_np, ms = matcher_outputs(model, pixels, timed=True)
            t2 = time.perf_counter()
            found = matcher.postprocess(out, img0.shape, img1.shape)
            t3 = time.perf_counter()
            prep_ms.append((t1 - t0) * 1e3)
            post_ms.append((t3 - t2) * 1e3)
            total_ms.append((t3 - t0) * 1e3)
            stages.append(ms)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                matcher.match(img0, img1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        here = os.path.dirname(os.path.abspath(__file__))
        syncs = [f"{os.path.relpath(x.filename, here)}:{x.lineno}" for x in caught
                 if "synchroniz" in str(x.message)]
        keypoints = [int(n) for n in card_np["mask"].sum(-1)]
        split = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
        rec = {"ms": statistics.median(total_ms), "host_prep_ms": statistics.median(prep_ms),
               **{f"{k}_ms": v for k, v in split.items()},
               "host_post_ms": statistics.median(post_ms), "keypoints": keypoints,
               "syncs": len(syncs), "peak_gib": peak_gib, "matches": int(found.kps0.shape[0])}
        print(f"  {name} pair {h}x{w} (shift {SG_SHIFT} px), median of {SG_TIMED} ({card}): "
              f"{rec['ms']:.2f} ms a pair by the host clock: preprocessing "
              f"{rec['host_prep_ms']:.2f} "
              f"(host), SuperPoint {split['superpoint']:.2f}, GNN {split['gnn']:.2f}, Sinkhorn and "
              f"extraction {split['sinkhorn']:.2f} (CUDA events), post-processing "
              f"{rec['host_post_ms']:.2f} (host); keypoints {keypoints}; {rec['matches']} mutual "
              f"matches at 0.0; {len(syncs)} waits for the device a pair ({sorted(set(syncs))}); "
              f"peak memory {peak_gib:.3f} GiB")
        require(min(keypoints) > 0 and rec["matches"] > 0, f"{name}: keypoints {keypoints}, "
                                                          f"matches {rec['matches']}")
        got, spread, limits, cpu_np = hold_to_cpu(card_np, cpu.model, pixels, ulp_rng, name)
        with fp32(), torch.inference_mode():
            torch.backends.cudnn.allow_tf32 = True  # fp32() restores it
            _, tf32_np, _ = matcher_outputs(model, pixels)
        tf32 = match_agreement(tf32_np, cpu_np, *pixels.shape[-2:])
        broken = over_sg_limits(tf32, limits)
        print(f"  {name} control, cuDNN's TF32 on: card vs CPU {fmt_sg(tf32)}; breaks "
              f"{broken or 'no limit'}")
        pairs[name] = dict(rec, agreement=got, cpu_spread=spread, limits=limits,
                           tf32_control=tf32, tf32_breaks=broken, sync_sites=sorted(set(syncs)))
    seconds = time.perf_counter() - started
    print(f"  phase 21: {seconds:.1f} s")
    return {"pairs": pairs, "phase21_s": seconds}, cpu


def phase_superglue_driver(dev, card, root, cpu):
    """Phase 22: the training CLI on a seeded fern-shaped scene with no
    ``matches.npz`` and ``matcher superglue``: the driver builds its match
    cache with phase 21's weights on the card, and PRD trains on it."""
    import io

    from scnerf_tpu_torch.cli import train as cli
    from scnerf_tpu_torch.matching.provider import PrecomputedMatches
    from scnerf_tpu_torch.matching.superglue_hf import HFSuperGlueMatcher
    from scnerf_tpu_torch.serve import fp32_inference
    from scnerf_tpu_torch.train import driver

    print("== phase 22: PRD training with matches the card made (fern-shaped scene, "
          "matcher superglue)")
    started = time.perf_counter()
    scene = write_fern_scene(os.path.join(root, "fern"))
    argv = ["--config", FERN_CONFIG, "--datadir", scene, "--basedir", os.path.join(root, "logs"),
            "--add_ie", "0", "--add_od", "0", "--add_prd", "0", "--i_print", "10",
            "--matcher", "superglue", "--match_threshold", "0.0",
            "--steps", str(SG_DRIVER_STEPS)]
    seen = {"prd": []}
    originals = (driver.matcher_from_config, driver.build_match_cache, driver.sample_prd_batch,
                 driver.build_experiment)

    def selecting(cam, device="cuda"):
        seen["matcher"] = originals[0](cam, device)
        return seen["matcher"]

    def building(images, pairs, provider, path=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = originals[1](images, pairs, provider, path)
        seen["cache_s"], seen["pairs"], seen["images"] = time.perf_counter() - t0, pairs, images
        return cache

    def drawing(exp):
        batch = originals[2](exp)
        seen["prd"].append(batch is not None)
        return batch

    def capturing(*args, **kwargs):
        seen["exp"] = originals[3](*args, **kwargs)
        return seen["exp"]

    (driver.matcher_from_config, driver.build_match_cache, driver.sample_prd_batch,
     driver.build_experiment) = selecting, building, drawing, capturing
    try:
        torch.cuda.synchronize()
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launch_counts()["K1"]
    finally:
        (driver.matcher_from_config, driver.build_match_cache, driver.sample_prd_batch,
         driver.build_experiment) = originals
    print("  " + "\n  ".join(out.getvalue().strip().splitlines()))
    require(rc == 0, f"cli.train.main returned {rc}")
    matcher, exp = seen.get("matcher"), seen["exp"]
    require(isinstance(matcher, HFSuperGlueMatcher) and matcher.device.type == dev.type,
            f"the driver's matcher is {type(matcher).__name__} on "
            f"{getattr(matcher, 'device', None)}, not the port's SuperGlue on the card")
    path = os.path.join(exp.logger.expdir, "matches.npz")
    require(os.path.exists(path) and "cache_s" in seen, "the driver wrote no matches.npz")
    cache = PrecomputedMatches(path)
    counts = [cache.get(i, j).kps0.shape[0] for i, j in cache.pairs()]
    require(len(counts) == len(seen["pairs"]) == len(exp.pair_list) and max(counts) > 0,
            f"matches.npz: {len(counts)} pairs of {len(exp.pair_list)}, counts {counts}")
    want_prd = -(-SG_DRIVER_STEPS // 10)
    require(seen["prd"] == [True] * want_prd,
            f"sample_prd_batch on the PRD steps: {seen['prd']}, want {want_prd} batches")
    chunks = -(-exp.H * exp.W // exp.render_cfg.chunk)
    want = SG_DRIVER_STEPS + 3 * chunks
    print(f"  match cache: {len(counts)} pairs in {seen['cache_s']:.2f} s "
          f"({seen['cache_s'] / len(counts) * 1e3:.1f} ms a pair), matches a pair min "
          f"{min(counts)} / median {statistics.median(counts)} / max {max(counts)}; PRD batches "
          f"on {len(seen['prd'])} PRD steps; the run {run_s:.2f} s; K1 launched {launches} times: "
          f"{SG_DRIVER_STEPS} train steps + 3 test views x {chunks} chunks = {want} ({card})")
    require(launches == want, f"K1 launched {launches} times, want {want}")

    # matches.npz as read back against the matcher rerun on the card on the
    # pair's train views, exactly; that rerun's raw outputs against the CPU
    # port's by phase 21's limits.
    images = seen["images"]
    require(np.array_equal(images, exp.images[exp.i_train]),
            "the driver matched other images than the train views")
    held = []
    for i, j in cache.pairs()[:SG_CPU_PAIRS]:
        pixels = matcher.prepare(images[i], images[j])
        with fp32_inference():
            out, card_np, _ = matcher_outputs(matcher.model, pixels)
        a, rerun = cache.get(i, j), matcher.postprocess(out, images[i].shape, images[j].shape)
        require(all(np.array_equal(getattr(a, f), getattr(rerun, f))
                    for f in ("kps0", "kps1", "confidence")),
                f"matches.npz pair ({i}, {j}) differs from the card's matcher on train views "
                f"{i} and {j}: {a} against {rerun}")
        got, _, _, _ = hold_to_cpu(card_np, cpu.model, pixels,
                                   np.random.default_rng(SEED + 22 + i), f"pair ({i}, {j})")
        b = cpu.match(images[i], images[j])
        same = len({tuple(r) for r in np.hstack([a.kps0, a.kps1])}
                   & {tuple(r) for r in np.hstack([b.kps0, b.kps1])})
        print(f"    pair ({i}, {j}) in matches.npz: {a.kps0.shape[0]} matches, equal to the card's "
              f"rerun; the CPU port's {b.kps0.shape[0]}, {same} the same")
        held.append(dict(got, pair=[i, j], cache_matches=int(a.kps0.shape[0]),
                         cpu_matches=int(b.kps0.shape[0]), same_matches=same))
    seconds = time.perf_counter() - started
    print(f"  phase 22: {seconds:.1f} s")
    return {"driver_pairs": len(counts), "driver_cache_s": seen["cache_s"],
            "driver_matches_min": min(counts), "driver_matches_median": statistics.median(counts),
            "driver_matches_max": max(counts), "driver_prd_batches": len(seen["prd"]),
            "driver_launches": launches, "driver_held_to_cpu": held, "phase22_s": seconds}


# ---------------------------------------------------------------------------
# Phases 23-26: the serving export, the profiling helpers, the native host
# library and data parallelism
# ---------------------------------------------------------------------------

EXPORT_PIXELS = 65536  # phase 23's request, each pipeline
EXPORT_TURNS = 3
# Phase 23's fresh process: torch and the loader alone. It loads each
# artifact, serves the request through RenderService, counts the kernels the
# loaded program launched by name under torch.profiler, and writes the maps.
LOADER = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from scnerf_tpu_torch.serve import RenderService, artifact_device, load_serving_fn
from scnerf_tpu_torch.train.profiling import profile_rows, trace
report = {}
for name, a in json.loads(sys.argv[2]).items():
    load_s = []
    for _ in range(2):  # the first load in a process also imports torch.export's modules
        t0 = time.perf_counter()
        fn = load_serving_fn(a["path"])
        load_s.append(time.perf_counter() - t0)
    service = RenderService(fn, a["batch"], device="cuda")
    inputs = [np.load(p) for p in a["inputs"]]
    service(*inputs)
    with trace(None, with_flops=False) as prof:
        maps = service(*inputs)
    kernels = {r[0]: r[2] for r in profile_rows(prof)[1] if r[1] == "cuda" and "sample_pdf" in r[0]}
    np.savez(a["out"], **maps)
    report[name] = {"load_s": load_s, "operators": fn.operators, "kernels": kernels,
                    "device": str(artifact_device(fn.exported))}
model = sorted(m for m in sys.modules
               if m.startswith(("scnerf_tpu_torch.render", "scnerf_tpu_torch.fields")))
print(json.dumps({"artifacts": report, "model_modules": model, "torch": torch.__version__}))
"""
K1_KERNEL, K2_KERNEL = "sample_pdf_kernel<false", "sample_pdf_kernel<true"


def serve_limits(got: dict, want: dict, what: str) -> float:
    """The serving limits (median |err| < 1e-5, max < 1e-3) on every map;
    returns the largest |err|."""
    worst = 0.0
    for k, v in want.items():
        err = np.abs(np.asarray(got[k], np.float64) - np.asarray(v, np.float64))
        require(float(np.median(err)) < 1e-5 and float(err.max()) < 1e-3,
                f"{what} {k}: median|err| {np.median(err):.3e}, max {err.max():.3e}")
        worst = max(worst, float(err.max()))
    return worst


def phase_export(dev, card, root):
    """Phase 23: the fern NeRF and the Truck NeRF++ serve functions exported
    on the card, loaded in a fresh process without the model code, held to
    the serve functions and timed against RenderService."""
    from scnerf_tpu_torch.camera import pixels_to_rays
    from scnerf_tpu_torch.serve import (
        RenderService, export_serving_fn, load_serving_fn, make_nerf_serve_fn,
        make_nerfpp_serve_fn, nerf_serve_specs, nerfpp_serve_specs,
    )

    print("== phase 23: the serving export at full fern and Truck width on the card")
    started = time.perf_counter()
    print(f"  torch {torch.__version__}")
    model_cfg, render_cfg, params, camera, ndc = make_slice(dev)
    pp_model, pp_render, levels, pp_camera = make_nerfpp_slice(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def pixels(cam, h, w, n_images):
        px = torch.randint(0, w, (EXPORT_PIXELS,), generator=gen, device=dev)
        py = torch.randint(0, h, (EXPORT_PIXELS,), generator=gen, device=dev)
        idx = torch.randint(0, n_images, (EXPORT_PIXELS,), generator=gen, device=dev)
        with torch.no_grad():
            return [x.cpu().numpy() for x in pixels_to_rays(cam, px, py, image_idx=idx)]

    n = EXPORT_PIXELS
    cases = {
        "nerf": (make_nerf_serve_fn(params, model_cfg, render_cfg, ndc=ndc),
                 nerf_serve_specs(BATCH), BATCH,
                 pixels(camera, H, W, N_IMAGES) + [np.zeros(n, np.float32),
                                                   np.ones(n, np.float32)]),
        "nerfpp": (make_nerfpp_serve_fn(levels, pp_model, pp_render),
                   nerfpp_serve_specs(PP_BATCH), PP_BATCH,
                   pixels(pp_camera, PP_H, PP_W, PP_IMAGES) + [np.full(n, 1e-4, np.float32)]),
    }
    spec, record = {}, {}
    for name, (fn, specs, batch, inputs) in cases.items():
        path = os.path.join(root, f"{name}.pt2")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = export_serving_fn(fn, specs, path, device=dev)
        export_s = time.perf_counter() - t0
        traced = launch_counts()
        files = []
        for i, x in enumerate(inputs):
            files.append(os.path.join(root, f"{name}_in{i}.npy"))
            np.save(files[-1], x)
        spec[name] = {"path": path, "batch": batch, "inputs": files,
                      "out": os.path.join(root, f"{name}_out.npz")}
        record[name] = {"export_s": export_s, "bytes": len(data)}
        print(f"  {name}: exported in {export_s:.2f} s, {len(data)} bytes "
              f"({len(data) / 2**20:.2f} MiB), batch {batch}; wrapper counts while tracing "
              f"(not launches): K1 {traced['K1']}, K2 {traced['K2']}")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", LOADER, os.path.dirname(os.path.abspath(__file__)),
                           json.dumps(spec)], capture_output=True, text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"the fresh loader process failed:\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    require(report["model_modules"] == [],
            f"the loader process imported model code: {report['model_modules']}")
    print(f"  fresh process (torch {report['torch']}, no scnerf_tpu_torch.render or .fields "
          f"module imported): {fresh_s:.1f} s in all")

    for name, (fn, _, batch, inputs) in cases.items():
        got_report = report["artifacts"][name]
        slices = -(-EXPORT_PIXELS // batch)
        k1 = sum(c for k, c in got_report["kernels"].items() if K1_KERNEL in k)
        k2 = sum(c for k, c in got_report["kernels"].items() if K2_KERNEL in k)
        want_k1, want_k2 = (slices, 0) if name == "nerf" else (0, 2 * slices)
        require(got_report["device"] == "cuda:0", f"{name}: artifact on {got_report['device']}")
        require((k1, k2) == (want_k1, want_k2),
                f"{name}: the loaded program launched K1 {k1} and K2 {k2} times; derived "
                f"{want_k1} and {want_k2} ({slices} slices)")
        service = RenderService(fn, batch, device=dev)
        want = service(*inputs)
        with np.load(spec[name]["out"]) as npz:
            got = {k: npz[k] for k in npz.files}
        require(set(got) == set(want), f"{name}: maps {sorted(got)}")
        worst = serve_limits(got, want, f"phase 23 {name}")
        loaded = RenderService(load_serving_fn(spec[name]["path"]), batch, device=dev)
        loaded(*inputs)
        rates = {"loaded": [], "RenderService": []}
        for _ in range(EXPORT_TURNS):
            for label, svc in (("loaded", loaded), ("RenderService", service)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc(*inputs)  # ends in a device->host copy
                rates[label].append(EXPORT_PIXELS / (time.perf_counter() - t0))
        rates = {k: statistics.median(v) for k, v in rates.items()}
        record[name].update(load_s=got_report["load_s"], max_abs_err=worst, k1=k1, k2=k2,
                            operators=got_report["operators"], rays_per_s=rates)
        print(f"  {name}: loaded in {got_report['load_s'][0]:.2f} s, then again in "
              f"{got_report['load_s'][1]:.2f} s in the fresh process, "
              f"operators {got_report['operators']}; K1 {k1} and K2 {k2} launches inside the "
              f"loaded program (derived {want_k1}, {want_k2}); max|err| against the serve "
              f"function {worst:.3e}; {EXPORT_PIXELS} rays, median of {EXPORT_TURNS} turns: "
              f"loaded {rates['loaded']:.1f} rays/s, RenderService {rates['RenderService']:.1f} "
              f"rays/s ({card})")
    seconds = time.perf_counter() - started
    print(f"  phase 23: {seconds:.1f} s")
    return dict(export=record, export_k1_launches=record["nerf"]["k1"],
                export_k2_launches=record["nerfpp"]["k2"], phase23_s=seconds)


def mlp_macs_per_point(params: dict) -> int:
    """Multiply-adds of one point through a NeRF MLP: every dense layer's
    ``in x out``."""
    from scnerf_tpu_torch.train.optim import named_leaves

    return sum(int(w.shape[0]) * int(w.shape[1]) for path, w in named_leaves(params).items()
               if path.endswith("/w"))


def phase_profiling(dev, card, train_device_ms):
    """Phase 24: ``measure_roofline`` over phase 10's fern train step."""
    from scnerf_tpu_torch.train.device_sampling import make_device_sampling_step
    from scnerf_tpu_torch.train.profiling import measure_roofline

    print("== phase 24: measure_roofline over the fern train step (phase 10's setup)")
    started = time.perf_counter()
    slice_ = make_slice(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    images = torch.rand((N_IMAGES, H, W, 3), generator=gen, device=dev)
    base, _, state = train_setup(slice_, dev)
    step = make_device_sampling_step(base, images, TRAIN_RAYS)
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, gen)
    torch.cuda.synchronize()
    held = [state]

    def run_steps(n):
        for _ in range(n):
            held[0], _ = step(held[0], gen)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        got = measure_roofline(run_steps, n_steps=TRAIN_PROFILED, logdir=logdir)
        traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        trace_mb = sum(os.path.getsize(os.path.join(logdir, f)) for f in traces) / 1e6
    require(set(got) == {"device_us_per_step", "measured_flops_per_step"},
            f"measure_roofline returned {got}")
    require(len(traces) == 1, f"trace files written: {traces}")
    device_ms = got["device_us_per_step"] / 1e3
    rel = abs(device_ms / train_device_ms - 1.0)
    require(rel < 0.10, f"measure_roofline's {device_ms:.3f} ms of device time a step against "
                        f"phase 10's {train_device_ms:.3f} ms: {rel:.2%} apart")
    render_cfg = slice_[1]
    points = TRAIN_RAYS * (render_cfg.n_samples + render_cfg.n_samples + render_cfg.n_importance)
    # Forward 2 FLOPs a multiply-add; the backward twice that (the weights'
    # and the inputs' gradients).
    derived = 3 * 2 * mlp_macs_per_point(slice_[2]["coarse"]) * points
    flops = got["measured_flops_per_step"]
    seconds = time.perf_counter() - started
    print(f"  device time {device_ms:.3f} ms a step against phase 10's {train_device_ms:.3f} ms "
          f"({rel:.2%} apart; limit 10%); measured {flops:.4e} FLOPs a step (the profiler's "
          f"formulas) against {derived:.4e} derived for the MLPs ({points} points a step, "
          f"forward and backward), ratio {flops / derived:.4f}; {flops / device_ms / 1e9:.2f} "
          f"TFLOP/s over the device time; trace {trace_mb:.1f} MB ({card}); phase "
          f"{seconds:.1f} s")
    return dict(roofline_device_ms=device_ms, roofline_rel_to_phase10=rel,
                roofline_flops=flops, roofline_derived_flops=derived, phase24_s=seconds)


def median_ms(fn, repeats: int = 5) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native(card):
    """Phase 25: the native host library on K4's shapes and on the pixel
    pool's permutation, against numpy."""
    from scnerf_tpu_torch import native

    print("== phase 25: the native host library (g++) against numpy")
    started = time.perf_counter()
    t0 = time.perf_counter()
    require(native.available(), "the native library did not build or load")
    print(f"  {native.library_path()} ready in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 25)
    record = {}
    for rows, n, m in SEARCH_SHAPES:
        a = np.sort(rng.random((rows, n)), -1).astype(np.float32)
        v = rng.random((rows, m)).astype(np.float32)
        for side in ("left", "right"):
            got = native.searchsorted_host(a, v, side)
            want = np.stack([np.searchsorted(a[i], v[i], side) for i in range(rows)])
            require(np.array_equal(got, want), f"searchsorted {side} on ({rows}, {n}, {m})")
        lib_ms = median_ms(lambda: native.searchsorted_host(a, v, "left"))
        np_ms = median_ms(lambda: [np.searchsorted(a[i], v[i]) for i in range(rows)])
        record[f"searchsorted_{rows}x{n}x{m}"] = {"native_ms": lib_ms, "numpy_ms": np_ms}
        print(f"  searchsorted ({rows} rows of {n}, {m} queries), both sides equal to numpy's: "
              f"{lib_ms:.3f} ms, numpy row by row {np_ms:.3f} ms")
    n = PP_H * PP_W
    perm = native.permutation_host(n, SEED)
    require(np.array_equal(np.sort(perm), np.arange(n)), "not a permutation")
    require(np.array_equal(perm, native.permutation_host(n, SEED)), "not the same for a seed")
    lib_ms = median_ms(lambda: native.permutation_host(n, SEED))
    np_ms = median_ms(lambda: np.random.RandomState(SEED).permutation(n))
    images = rng.random((2, PP_H, PP_W, 3), dtype=np.float32)
    img = (perm % 2).astype(np.int64)
    px, py = perm % PP_W, (perm // PP_W) % PP_H
    require(np.array_equal(native.gather_pixels_host(images, img, px, py), images[img, py, px]),
            "gather_pixels_host")
    gather_ms = median_ms(lambda: native.gather_pixels_host(images, img, px, py))
    fancy_ms = median_ms(lambda: images[img, py, px])
    record["permutation"] = {"native_ms": lib_ms, "numpy_ms": np_ms}
    record["gather_pixels"] = {"native_ms": gather_ms, "numpy_ms": fancy_ms}
    seconds = time.perf_counter() - started
    print(f"  permutation of the pool's {n} pixels: {lib_ms:.3f} ms, np.random.permutation "
          f"{np_ms:.3f} ms; gather of {n} pixels {gather_ms:.3f} ms, numpy indexing "
          f"{fancy_ms:.3f} ms (host of the {card} machine); phase {seconds:.1f} s")
    return dict(native=record, phase25_s=seconds)


DP_STEPS = 5
DP_TURNS = 3
DP_SERVE_PIXELS = 16384


def phase_distributed(dev, card):
    """Phase 26: NCCL at world size 1: the data-parallel NeRF step against
    the plain step, and the grouped service against the ungrouped one."""
    import socket

    import torch.distributed as dist

    from scnerf_tpu_torch import distributed as tdist
    from scnerf_tpu_torch.camera import pixels_to_rays
    from scnerf_tpu_torch.serve import RenderService, make_nerf_serve_fn
    from scnerf_tpu_torch.train.device_sampling import make_device_sampling_step
    from scnerf_tpu_torch.train.optim import named_leaves

    print("== phase 26: data parallelism on NCCL at world size 1")
    started = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    topo = tdist.initialize_runtime(f"localhost:{port}", 1, 0, backend="nccl", timeout_s=120)
    try:
        require(topo == {"process_index": 0, "process_count": 1, "local_devices": 1,
                         "global_devices": 1} and dist.get_backend() == "nccl",
                f"topology {topo}, backend {dist.get_backend()}")
        slice_ = make_slice(dev)
        images = torch.rand((N_IMAGES, H, W, 3),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 26),
                            device=dev)
        runs = {}
        for label, group in (("plain", None), ("plain again", None),
                             ("data-parallel", dist.group.WORLD)):
            base, _, state = train_setup(slice_, dev, group=group)
            runs[label] = [make_device_sampling_step(base, images, TRAIN_RAYS), state,
                           torch.Generator(device=dev).manual_seed(SEED + 260)]
        # The camera rows' and noise cells' gradients are index_add's sums,
        # which add in a varying order (atomics) unless PyTorch's
        # deterministic kernels are asked for: the plain step alone is then
        # not bit-reproducible. Compare under them; time without them.
        import warnings

        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        losses = {label: [] for label in runs}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(DP_STEPS):
                    for label, run in runs.items():
                        run[1], m = run[0](run[1], run[2])
                        losses[label].append(float(m["loss"]))
        finally:
            torch.use_deterministic_algorithms(False)
        undetermined = sorted({str(w.message).split(".")[0] for w in caught
                               if "deterministic" in str(w.message)})
        require(len({tuple(v) for v in losses.values()}) == 1, f"losses {losses}")
        leaves = {label: named_leaves(run[1].params) for label, run in runs.items()}
        for label in ("plain again", "data-parallel"):
            unequal = [k for k, x in leaves["plain"].items()
                       if not torch.equal(x, leaves[label][k])]
            require(not unequal, f"{label}: parameters not bit-equal to the plain step's after "
                                 f"{DP_STEPS} steps: {unequal} (operators without a "
                                 f"deterministic kernel: {undetermined})")
        del runs["plain again"]
        ms = {label: [] for label in runs}
        for _ in range(DP_TURNS):
            for label, run in runs.items():
                run[1], _, step_ms = time_steps(lambda s, r=run: r[0](s, r[2]), run[1], DP_STEPS)
                ms[label].append(step_ms)
        ms = {label: statistics.median(v) for label, v in ms.items()}
        print(f"  {DP_STEPS} steps from one state and one generator's draws, deterministic "
              f"kernels: losses and every parameter of the plain step, its rerun and the "
              f"data-parallel step bit-equal (operators that warned of no deterministic "
              f"kernel: {undetermined or 'none'}); ms a step by CUDA events, median of "
              f"{DP_TURNS} turns of "
              f"{DP_STEPS}: plain {ms['plain']:.3f}, data-parallel {ms['data-parallel']:.3f} "
              f"({card})")
        model_cfg, render_cfg, params, camera, ndc = slice_
        fn = make_nerf_serve_fn(params, model_cfg, render_cfg, ndc=ndc)
        gen = torch.Generator(device=dev).manual_seed(SEED + 27)
        px = torch.randint(0, W, (DP_SERVE_PIXELS,), generator=gen, device=dev)
        py = torch.randint(0, H, (DP_SERVE_PIXELS,), generator=gen, device=dev)
        with torch.no_grad():
            rays = pixels_to_rays(camera, px, py, image_idx=0)
        near, far = torch.zeros(DP_SERVE_PIXELS, device=dev), torch.ones(DP_SERVE_PIXELS,
                                                                         device=dev)
        grouped = RenderService(fn, BATCH, device=dev, group=dist.group.WORLD)(*rays, near, far)
        single = RenderService(fn, BATCH, device=dev)(*rays, near, far)
        require(all(np.array_equal(grouped[k], single[k]) for k in single),
                "RenderService(group=) differs from the ungrouped service")
        print(f"  RenderService(group=) on {DP_SERVE_PIXELS} rays equal to the ungrouped "
              f"service")
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - started
    print(f"  phase 26: {seconds:.1f} s")
    return dict(dp_step_ms=ms, phase26_s=seconds)



ABLATION_STEPS = 300  # phase 27's horizon a row: add_od 50, add_prd 100, as the script derives
EXAMPLE_STEPS = 300  # phase 28's, but distortion_discovery's own 1,500


def relay(text: str, prefixes: tuple = ()) -> None:
    """The lines of a captured run (those starting with ``prefixes`` when
    given), indented."""
    lines = [line for line in text.strip().splitlines()
             if not prefixes or line.startswith(prefixes)]
    if lines:
        print("  " + "\n  ".join(lines))


def phase_ablation(dev, card, root):
    """Phase 27: ``scripts/ablation_curriculum.main`` at full width over 300
    steps a row, on the card, held to the CPU port where it can be."""
    import io

    from scnerf_tpu_torch.data.blender import load_blender
    from scnerf_tpu_torch.scripts import _analytic_scene, ablation_curriculum, soak_nerf
    from scnerf_tpu_torch.train import driver

    print(f"== phase 27: the curriculum ablation at full width, {ABLATION_STEPS} steps a row")
    started = time.perf_counter()
    t0 = time.perf_counter()
    card_views = _analytic_scene.build_blender_scene(os.path.join(root, "scene_card"), device=dev)
    scene_s = time.perf_counter() - t0
    cpu_views = _analytic_scene.build_blender_scene(os.path.join(root, "scene_cpu"), device="cpu")
    err = np.concatenate([np.abs(card_views[k] - cpu_views[k]).ravel() for k in card_views])
    print(f"  the analytic scene's 16 views of 120x160 (192 samples a ray) on the card in "
          f"{scene_s:.2f} s; against the CPU port: median |err| {np.median(err):.3e}, max "
          f"{err.max():.3e}")
    require(np.median(err) < 1e-6 and err.max() < 1e-4,
            f"GT views, card against CPU: median {np.median(err)}, max {err.max()}")

    captured, launches, prd_batches = {}, {}, []
    build, run_row = driver.build_experiment, ablation_curriculum.run_row

    def capturing(cfg, expdir=None, **kwargs):
        exp = build(cfg, expdir, **kwargs)
        exp.step_fn = StepRecorder(exp.step_fn)
        if exp.step_prd_fn is not None:
            prd_fn = exp.step_prd_fn

            def keeping_masks(state, batch, generator):
                prd_batches.append(batch["kp_mask"])
                return prd_fn(state, batch, generator)

            exp.step_prd_fn = StepRecorder(keeping_masks)
        captured[cfg.logging.expname] = exp
        return exp

    def counted_row(name, *args, **kwargs):
        torch.cuda.synchronize()
        reset_launches()
        out = run_row(name, *args, **kwargs)
        torch.cuda.synchronize()
        launches[name] = launch_counts()["K1"]
        return out

    driver.build_experiment = capturing
    ablation_curriculum.run_row = counted_row
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            report = ablation_curriculum.main(ABLATION_STEPS, None, os.path.join(root, "ablation"),
                                              device=dev)
    finally:
        driver.build_experiment = build
        ablation_curriculum.run_row = run_row
    relay(out.getvalue(), ("[ablation",))
    require(report["curriculum"] == {"add_od": ABLATION_STEPS // 6, "add_prd": ABLATION_STEPS // 3},
            f"curriculum {report['curriculum']}")

    rows = {r["name"]: r for r in report["rows"]}
    require(list(rows) == ["gt_poses", "noisy_no_calib", "ie", "ie_od", "ie_od_prd"],
            f"rows {list(rows)}")
    record = {}
    for name, row in rows.items():
        exp = captured[name]
        require(exp.device.type == "cuda", f"row {name} built on {exp.device}")
        numbers = [row["heldout_psnr"], row["heldout_ssim"], row["final_train_loss"],
                   *row["camera_err_initial"].values(), *row["camera_err_final"].values()]
        require(all(math.isfinite(v) for v in numbers), f"row {name}: {row}")
        calls = sorted(exp.step_fn.read() + (exp.step_prd_fn.read() if exp.step_prd_fn else []),
                       key=lambda c: c[0])
        # Each call is recorded with the step count after it: 1 for step 0.
        require([c[0] for c in calls] == list(range(1, ABLATION_STEPS + 1)),
                f"row {name}'s steps")
        for step, _, m in calls:
            require(all(math.isfinite(v) for v in m.values()), f"row {name} step {step}: {m}")
        first, last = calls[0][2]["loss"], calls[-1][2]["loss"]
        require(last < first, f"row {name}: the last loss {last} is not below the first {first}")
        prd_calls = [c for c in calls if "prd" in c[2]]
        if name == "ie_od_prd":
            add_prd = exp.curriculum.add_prd
            want = [it + 1 for it in range(ABLATION_STEPS) if it >= add_prd and it % 10 == 0]
            prd_steps = [c[0] for c in prd_calls]
            require(prd_steps == want, f"PRD steps {prd_steps}, want {want}")
            in_batch = [int(m.sum()) for m in prd_batches]
            matches = [int(c[2]["prd_matches"]) for c in prd_calls]
            print(f"  {name}: on the PRD steps {prd_steps}: matches in the batch {in_batch}, "
                  f"valid {matches}")
            require(len(in_batch) == len(want) and min(in_batch) > 0,
                    f"PRD steps without a match batch: {in_batch}")
            # A match counts only while both of its reprojections stay
            # within 5 px^2, and at step 100 a pair's errors sit near that:
            # the first PRD step's pair (the same in every run) read 440
            # and 400 valid matches in two runs on the card and 0 in a
            # third, the card's atomics parting the trajectories. PRD is
            # live when most of its steps take valid matches.
            live = sum(n > 0 for n in matches)
            require(2 * live > len(matches),
                    f"valid PRD matches on {live} of {len(matches)} PRD steps: {matches}")
        else:
            require(not prd_calls, f"row {name} took PRD steps")
        views = len(exp.i_test)
        chunks = -(-exp.H * exp.W // exp.render_cfg.chunk)
        want = ABLATION_STEPS + views * chunks
        require(launches[name] == want, f"row {name}: K1 launched {launches[name]} times, want "
                                        f"{ABLATION_STEPS} steps + {views} views x {chunks} chunks")
        ms = {"plain": percentiles([c[1] for c in calls if "prd" not in c[2] and c[0] > 2]),
              "prd": percentiles([c[1] for c in prd_calls])}
        record[name] = dict(psnr=row["heldout_psnr"], ssim=row["heldout_ssim"], step_ms=ms,
                            camera_err_initial=row["camera_err_initial"],
                            camera_err_final=row["camera_err_final"], wall_s=row["wall_s"],
                            launches=launches[name],
                            prd_matches_first=prd_calls[0][2]["prd_matches"] if prd_calls else None)
        print(f"  {name}: held-out PSNR {row['heldout_psnr']:.3f} dB, SSIM "
              f"{row['heldout_ssim']:.4f}; loss {first:.5f} -> {last:.5f}; ms a step by CUDA "
              f"events (after the first two) plain {ms['plain']}, PRD {ms['prd']}; camera "
              f"errors {row['camera_err_initial']} -> {row['camera_err_final']}; K1 "
              f"{launches[name]} = {ABLATION_STEPS} + {views} x {chunks}; train {row['wall_s']} s")

    initial = [rows[n]["camera_err_initial"] for n in ("ie", "ie_od", "ie_od_prd")]
    require(initial[0] == initial[1] == initial[2], f"initial camera errors differ: {initial}")
    flags = dict(ablation_curriculum.rows_spec(ABLATION_STEPS))["ie"]
    cfg = ablation_curriculum.row_config("ie", os.path.join(root, "ablation", "scene"),
                                         os.path.join(root, "cpu"), flags, small=False)
    cpu_err = soak_nerf.camera_errors(driver.build_experiment(cfg, None, device="cpu"))
    rel = max(abs(initial[0][k] - v) / abs(v) for k, v in cpu_err.items())
    print(f"  initial camera errors, the same in the three camera rows: {initial[0]}; the CPU "
          f"port's from the same config: relative {rel:.3e}")
    require(rel <= 1e-6, f"initial camera errors on the CPU port {cpu_err}")

    d = load_blender(os.path.join(root, "scene_cpu"), testskip=1)
    matches_path = os.path.join(root, "matches_cpu.npz")
    soak_nerf.write_exact_matches(matches_path, d.gt_poses, d.i_split[0], d.gt_intrinsic[0, 0],
                                  d.H, d.W)
    got = np.load(os.path.join(root, "ablation", "ie_od_prd", "matches.npz"))
    want = np.load(matches_path)
    require(sorted(got.files) == sorted(want.files)
            and all(np.array_equal(got[k], want[k]) for k in want.files),
            "the PRD row's matches.npz differs from the CPU scene's exact matches")
    gain = report["full_vs_noisy_gain_db"]
    seconds = time.perf_counter() - started
    print(f"  exact matches: {len(want.files) // 2} pairs, equal to the CPU scene's; full method "
          f"against the noisy baseline {gain:+.2f} dB (the 3 dB gate {report['gain_gate_pass']}, "
          f"not held at {ABLATION_STEPS} steps); rotation error shrinks in every camera row: "
          f"{report['rot_err_shrinks_all_camera_rows']}; classical baselines "
          f"{report['classical_baselines']}; phase {seconds:.1f} s ({card})")
    return dict(ablation=record, ablation_gain_db=gain,
                ablation_classical=report["classical_baselines"], phase27_s=seconds)


@contextlib.contextmanager
def first_resamples(kept: dict):
    """K1's inputs and outputs, the first call at each shape, kept in
    ``kept`` by ``(bins, weights, u)`` shapes while the block runs."""
    from scnerf_tpu_torch.render import renderer

    core = renderer.sample_pdf_core

    def recording(bins, weights, u):
        out = core(bins, weights, u)
        shapes = tuple(tuple(x.shape) for x in (bins, weights, u))
        if shapes not in kept:
            kept[shapes] = tuple(x.detach().clone() for x in (bins, weights, u, out))
        return out

    renderer.sample_pdf_core = recording
    try:
        yield kept
    finally:
        renderer.sample_pdf_core = core


def phase_examples(dev, card):
    """Phase 28: the four examples on the card. K1 is held against its plain
    twin on the first call at each shape the examples give it (48 fine
    samples: half of each lane's second u slot is empty, a branch the
    64-sample shapes of phases 2 and 10 do not take)."""
    import io

    from scnerf_tpu_torch.kernels import pdf_cuda

    from scnerf_tpu_torch.examples import (
        _common,
        calibration_ablation,
        distortion_discovery,
        from_scratch_calibration,
        self_calibration_demo,
    )

    print("== phase 28: the four examples on the card")
    started = time.perf_counter()
    record = {}
    # K1 launches: one a train step, one a chunk of 8,192 rays of each held-out
    # 100x100 render (two test views in each arm of the ablation, one from
    # scratch); the distortion rig renders nothing.
    # K1's rows: 1,024 a train step; a 100x100 render in chunks of 8,192,
    # the last edge-padded.
    chunks = -(-100 * 100 // 8192)
    train, render = [1024], [8192]
    runs = ((distortion_discovery, None, 0, []),
            (calibration_ablation, EXAMPLE_STEPS, 2 * EXAMPLE_STEPS + 2 * 2 * chunks,
             train + render),
            (self_calibration_demo, EXAMPLE_STEPS, EXAMPLE_STEPS, train),
            (from_scratch_calibration, EXAMPLE_STEPS, EXAMPLE_STEPS + chunks, train + render))
    for module, steps, want_launches, want_rows in runs:
        name = module.__name__.rsplit(".", 1)[-1]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        resamples = {}
        with contextlib.redirect_stdout(out), first_resamples(resamples):
            got = module.main(steps=steps, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1 = launch_counts()["K1"]
        relay(out.getvalue())
        outcome = {k: v for k, v in got.items() if k != "curve"}
        print(f"  {name}: {json.dumps(outcome)}; K1 {k1}; {seconds:.1f} s ({card})")
        require(k1 == want_launches, f"{name}: K1 launched {k1} times, want {want_launches}")
        require(sorted(s[0][0] for s in resamples) == sorted(want_rows),
                f"{name}: K1's rows at the shapes seen {list(resamples)}, want {want_rows}")
        k1_errs = []
        for shapes, (bins, weights, u, depths) in resamples.items():
            want = pdf_cuda.sample_pdf_plain(bins, weights, u)
            what = f"{name}: K1 at {shapes}"
            # The evaluation's deterministic u ends at exactly 1.0: there the
            # sample lands on the last edge or, when cdf[-1] rounds above 1,
            # near the one before, and the kernel's running sum and
            # torch.cumsum round apart on a few percent of rays.
            ends_at_one = bool((u[:, -1] == 1.0).all())
            cols = slice(None, -1) if ends_at_one else slice(None)
            med, mx, flips = check_resample(depths[:, cols], want[:, cols], bins, what)
            k1_errs.append(mx)
            print(f"  {what}: median|err|={med:.3e} max|err|={mx:.3e} share>1e-4={flips:.2e} "
                  f"against its plain twin" + (" on the samples with u < 1" if ends_at_one else ""))
            if ends_at_one:
                lo, hi = bins[:, -2] - 1e-5, bins[:, -1] + 1e-5
                for x in (depths[:, -1], want[:, -1]):
                    require(bool(((x >= lo) & (x <= hi)).all()),
                            f"{what}: a sample at u = 1 outside the last bin")
                moved = float(((depths[:, -1] - want[:, -1]).abs() > 1e-4).float().mean())
                print(f"  {what}: the samples at u = 1 within the last bin, {moved:.2%} of rays "
                      f"on the other end of it than the twin's")
        require(_common.all_finite(outcome), f"{name}: not finite: {outcome}")
        if module is distortion_discovery:
            require(got["k_err_final"] < got["k_err_initial"]
                    and got["prd_final"] < got["prd_initial"],
                    f"{name}: k error {got['k_err_initial']} -> {got['k_err_final']}, PRD "
                    f"{got['prd_initial']} -> {got['prd_final']}")
        else:
            arms = [got["with_camera"], got["without_camera"]] \
                if module is calibration_ablation else [got]
            for arm in arms:
                require(arm["loss_last"] < arm["loss_first"],
                        f"{name}: loss {arm['loss_first']} -> {arm['loss_last']}")
        record[name] = dict(outcome, launches=k1, seconds=seconds,
                            k1_max_abs_err=max(k1_errs, default=None))
    seconds = time.perf_counter() - started
    print(f"  phase 28: {seconds:.1f} s")
    return dict(examples=record, phase28_s=seconds)


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
        del driver_out
        truck_record, truck_exp, truck_out = phase_truck_driver(dev, card, root)
        truck_record.update(phase_render_cli(dev, card, root, driver_exp))
        truck_record.update(phase_truck_cpu_agreement(truck_exp, truck_out, root))
        del driver_exp, truck_exp, truck_out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_superglue_") as root:
        hub = os.environ.get("HF_HUB_CACHE")
        os.environ["HF_HUB_CACHE"] = os.path.join(root, "hub")  # phase 21 writes the weights
        try:
            match_record, cpu_matcher = phase_superglue(dev, card, root)
            match_record.update(phase_superglue_driver(dev, card, root, cpu_matcher))
        finally:
            if hub is None:
                os.environ.pop("HF_HUB_CACHE")
            else:
                os.environ["HF_HUB_CACHE"] = hub

    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
        export_record = phase_export(dev, card, root)
    export_record.update(phase_profiling(dev, card, train_record["train_device_ms"]))
    export_record.update(phase_native(card))
    export_record.update(phase_distributed(dev, card))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ablation_") as root:
        experiment_record = phase_ablation(dev, card, root)
    experiment_record.update(phase_examples(dev, card))

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
        "superglue_driver_launches": match_record["driver_launches"],
        "render_cli_launches": truck_record["render_cli_k1_launches"],
        "export_launches": export_record["export_k1_launches"],
        "ablation_launches": {name: row["launches"]
                              for name, row in experiment_record["ablation"].items()},
        "examples_launches": {name: ex["launches"]
                              for name, ex in experiment_record["examples"].items()},
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
        "driver_launches": truck_record["truck_launches"],
        "driver_cdf_launches": truck_record["truck_cdf_launches"],
        "render_cli_launches": truck_record["render_cli_k2_launches"],
        "export_launches": export_record["export_k2_launches"],
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
                  **driver_record, **truck_record},
        "matching": match_record,
        "runtime": export_record,
        "experiments": experiment_record,
        "seconds": seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
