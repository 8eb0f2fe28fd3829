"""Render and evaluation CLI of the port.

    python -m scnerf_tpu_torch.cli.render --config configs/llff/fern_ours.txt \
        [--split test|train|path] [--render_splits train,test] [--max_views N] \
        [--ckpt_dir DIR] [--out DIR] [--device cuda|cpu] [--key value ...]

Port of ``scnerf_tpu/cli/render.py``: builds the experiment of any family
(LLFF, blender, NeRF++) on ``--device`` (default ``cuda``; without a card it
exits with code 2), restores the latest checkpoint (``[render] restored step
N``), renders the chosen split and prints its metrics as an ``[eval]`` line.
Unlike the JAX CLI, which ignores them, ``--key value`` tokens override the
config as they do for ``cli/train.py``.

- LLFF and blender: ``train`` renders each train view at its learned
  extrinsic (trainset PSNR); ``test`` runs the ATE-aligned test-view
  evaluation (PSNR, SSIM, LPIPS when weights are given) and the GT-filtered
  test PRD, then writes the aligned renders; ``path`` renders the LLFF spiral
  or blender's spherical path (its first ``--max_views`` frames) and writes
  a video (``tools/video.py``: an mp4, or its ``.npz`` without an encoder).
  The JAX CLI's LLFF path stacks its poses wrongly and raises; the port
  builds each 4x4 pose from the path's 3x4.
- NeRF++: the held-out split (``train`` for the train views): PSNR, SSIM
  (and LPIPS), then ``NNN.png``, ``NNN_fg.png``, ``NNN_bg.png``,
  ``NNN_depth.png`` and ``<expname>.txt``.

Every image is written by ``core/imaging.write_png``, into ``--out``
(default ``basedir/expname/render_<split>``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="scnerf-tpu renderer on PyTorch")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--split", type=str, default="test", choices=["test", "train", "path"])
    parser.add_argument("--render_splits", type=str, default=None,
                        help="comma list, e.g. 'train,test': renders each in turn")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--max_views", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default cuda)")
    args, unknown = parser.parse_known_args(argv)

    if args.render_splits:
        rc = 0
        for s in args.render_splits.split(","):
            s = s.strip()
            if s in ("validation", "val"):
                s = "test"  # the held-out split's name differs per family
            sub = ["--config", args.config, "--split", s, "--device", args.device]
            if args.ckpt_dir:
                sub += ["--ckpt_dir", args.ckpt_dir]
            if args.max_views is not None:
                sub += ["--max_views", str(args.max_views)]
            rc = rc or main(sub + unknown)
        return rc

    from scnerf_tpu_torch.cli.train import device_or_exit, parse_overrides
    from scnerf_tpu_torch.core.config import load_experiment

    device = device_or_exit(args.device, "scnerf_tpu_torch.cli.render")
    if device is None:
        return 2
    cfg = load_experiment(args.config, parse_overrides(unknown))
    expdir = os.path.join(cfg.logging.basedir, cfg.logging.expname)
    ckpt_dir = args.ckpt_dir or os.path.join(expdir, "ckpts")
    out_dir = args.out or os.path.join(expdir, f"render_{args.split}")
    os.makedirs(out_dir, exist_ok=True)
    if cfg.dataset.dataset_type == "nerfpp":
        _render_nerfpp(cfg, expdir, ckpt_dir, out_dir, args, device)
    else:
        _render_nerf(cfg, expdir, ckpt_dir, out_dir, args, device)
    print(f"[render] wrote {out_dir}")
    return 0


def _restore(exp, ckpt_dir: str) -> None:
    from scnerf_tpu_torch.train.checkpoint import restore_checkpoint

    restored = restore_checkpoint(ckpt_dir, exp.state)
    if restored is not None:
        exp.state = restored
        print(f"[render] restored step {restored.step} from {ckpt_dir}")
    else:
        print("[render] no checkpoint found; rendering with initial params")


def _render_nerf(cfg, expdir, ckpt_dir, out_dir, args, device) -> None:
    """The LLFF and blender splits."""
    from scnerf_tpu_torch.camera.model import get_extrinsic
    from scnerf_tpu_torch.core.imaging import to8b, write_png
    from scnerf_tpu_torch.data.blender import spherical_render_poses
    from scnerf_tpu_torch.data.llff import load_llff
    from scnerf_tpu_torch.tools.video import array_to_video
    from scnerf_tpu_torch.train.driver import (
        _psnr,
        aligned_eval_extrinsic,
        build_experiment,
        evaluate_prd_split,
        evaluate_test_views,
        render_image,
    )

    exp = build_experiment(cfg, expdir, device=device)
    _restore(exp, ckpt_dir)
    camera = exp.state.params.get("camera")
    if args.split == "train":
        # The trainset render with the learned camera: each train view at its
        # learned extrinsic.
        psnrs = []
        for n, idx in enumerate(exp.i_train[:args.max_views]):
            if camera is not None:
                c2w = get_extrinsic(camera, n).detach()
            else:
                c2w = exp.noisy_poses[int(idx)]
            rgb = render_image(exp, c2w)["rgb"]
            psnrs.append(_psnr(rgb, exp.images[int(idx)]))
            write_png(os.path.join(out_dir, f"{n:03d}.png"), to8b(rgb))
        print(f"[eval] trainset psnr={np.mean(psnrs):.2f} views={len(psnrs)}")
    elif args.split == "test":
        results = evaluate_test_views(exp, max_views=args.max_views)
        results.update(evaluate_prd_split(exp, mode="test"))
        extra = "".join(f" {k}={results[k]:.4f}" for k in ("lpips", "prd_test") if k in results)
        print(f"[eval] psnr={results['psnr']:.2f} ssim={results['ssim']:.4f} "
              f"views={results['n_views']}{extra}")
        for n, idx in enumerate(exp.i_test[:args.max_views]):
            c2w = (aligned_eval_extrinsic(exp, int(idx)) if camera is not None
                   else exp.gt_poses[int(idx)])
            write_png(os.path.join(out_dir, f"{n:03d}.png"), to8b(render_image(exp, c2w)["rgb"]))
    else:
        # The spiral (LLFF) or spherical (blender) render path, as a video.
        if cfg.dataset.dataset_type == "blender":
            path = spherical_render_poses()
        else:
            rp = load_llff(cfg.dataset.datadir, factor=cfg.dataset.factor).render_poses
            path = np.broadcast_to(np.eye(4, dtype=np.float32), (len(rp), 4, 4)).copy()
            path[:, :3, :4] = rp[:, :3, :4]
        frames = []
        for n, c2w in enumerate(path[:args.max_views]):
            frames.append(render_image(exp, c2w)["rgb"])
            write_png(os.path.join(out_dir, f"{n:03d}.png"), to8b(frames[-1]))
        written = array_to_video(np.stack(frames), os.path.join(out_dir, "video.mp4"))
        print(f"[render] video {written}")
    if exp.logger:
        exp.logger.close()


def _render_nerfpp(cfg, expdir, ckpt_dir, out_dir, args, device) -> None:
    """NeRF++ split rendering and metrics: rgb, fg and bg rgb and the
    colorized fg depth of each view, and a summary file."""
    from scnerf_tpu_torch.core.imaging import colorize_depth, to8b, write_png
    from scnerf_tpu_torch.train.nerfpp_driver import (
        _held_out_data,
        build_nerfpp_experiment,
        evaluate_nerfpp,
        render_nerfpp_image,
    )

    exp = build_nerfpp_experiment(cfg, expdir, device=device)
    _restore(exp, ckpt_dir)
    data = _held_out_data(exp) if args.split != "train" else exp.train_data
    res = evaluate_nerfpp(exp, max_views=args.max_views, data=data)
    extra = f" lpips={res['lpips']:.4f}" if "lpips" in res else ""
    print(f"[eval] psnr={res['psnr']:.2f} ssim={res['ssim']:.4f} "
          f"views={res['n_views']} split={res['split']}{extra}")
    for i in range(res["n_views"]):
        # The views the metrics were computed on, along the same ray path.
        if data is not None and data is not exp.train_data:
            out = render_nerfpp_image(exp, c2w=data.poses[i], K=data.intrinsics[i],
                                      hw=(data.H, data.W))
        else:
            out = render_nerfpp_image(exp, img_idx=i)
        write_png(os.path.join(out_dir, f"{i:03d}.png"), to8b(out["rgb"]))
        write_png(os.path.join(out_dir, f"{i:03d}_fg.png"), to8b(out["fg_rgb"]))
        write_png(os.path.join(out_dir, f"{i:03d}_bg.png"), to8b(out["bg_rgb"]))
        write_png(os.path.join(out_dir, f"{i:03d}_depth.png"),
                  to8b(colorize_depth(out["fg_depth"])))
    with open(os.path.join(out_dir, f"{cfg.logging.expname}.txt"), "w") as f:
        f.write(f"psnr {res['psnr']:.4f}\nssim {res['ssim']:.4f}\n")
        if "lpips" in res:
            f.write(f"lpips {res['lpips']:.4f}\n")
    if exp.logger:
        exp.logger.close()


if __name__ == "__main__":
    raise SystemExit(main())
