"""Export CLI of the port: checkpoint -> portable serving artifact.

    python -m scnerf_tpu_torch.cli.export --config cfg.txt [--out serve.pt2] \
        [--batch 8192] [--ckpt_dir DIR] [--device cuda|cpu] [--key value ...]

Port of ``scnerf_tpu/cli/export.py``: restores the latest checkpoint of the
experiment (either pipeline; ``cli/render.py:_restore``), builds the
fixed-batch eval-semantics serve function (:mod:`scnerf_tpu_torch.serve`;
the LLFF NDC warp with the learned focal), exports it with ``torch.export``
on ``--device`` (default ``cuda``; without a card it exits with code 2) with
the weights as constants, and writes ``<out>.json`` with the artifact's
calling convention: the JAX CLI's keys, plus ``device`` and
``operator_library`` (null, or the path of K1's and K2's plain-C library,
``kernels._build.build("sample_pdf")``, where the artifact calls the port's
registered operators, as a CUDA artifact does; their CUDA implementations
load it at the first launch). The default artifact is
``<expdir>/serve.pt2``.
"""
from __future__ import annotations

import argparse
import io
import json
import os

import torch


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if hasattr(tree, "detach") else tree


def main(argv=None):
    parser = argparse.ArgumentParser(description="scnerf-tpu serving export on PyTorch")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--out", type=str, default=None,
                        help="artifact path (default <expdir>/serve.pt2)")
    parser.add_argument("--batch", type=int, default=8192,
                        help="fixed ray-batch size traced into the artifact")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to export on (default cuda)")
    args, unknown = parser.parse_known_args(argv)

    from scnerf_tpu_torch.cli.render import _restore
    from scnerf_tpu_torch.cli.train import device_or_exit, parse_overrides
    from scnerf_tpu_torch.core.config import load_experiment
    from scnerf_tpu_torch.kernels import _build
    from scnerf_tpu_torch.serve import artifact_operators, export_serving_fn

    device = device_or_exit(args.device, "scnerf_tpu_torch.cli.export")
    if device is None:
        return 2
    cfg = load_experiment(args.config, parse_overrides(unknown))
    expdir = os.path.join(cfg.logging.basedir, cfg.logging.expname)
    ckpt_dir = args.ckpt_dir or os.path.join(expdir, "ckpts")
    out_path = args.out or os.path.join(expdir, "serve.pt2")

    if cfg.dataset.dataset_type == "nerfpp":
        from scnerf_tpu_torch.serve import make_nerfpp_serve_fn, nerfpp_serve_specs
        from scnerf_tpu_torch.train.nerfpp_driver import build_nerfpp_experiment

        exp = build_nerfpp_experiment(cfg, expdir, device=device)
        _restore(exp, ckpt_dir)
        fn = make_nerfpp_serve_fn(_detached(exp.state.params["levels"]), exp.model_cfg,
                                  exp.render_cfg)
        specs = nerfpp_serve_specs(args.batch)
        meta = {
            "pipeline": "nerfpp",
            "inputs": ["ray_o (B,3) f32", "ray_d (B,3) f32", "min_depth (B,) f32"],
            "outputs": ["rgb", "fg_depth", "bg_lambda"],
        }
    else:
        from scnerf_tpu_torch.serve import make_nerf_serve_fn, nerf_serve_specs
        from scnerf_tpu_torch.train.driver import build_experiment

        exp = build_experiment(cfg, expdir, device=device)
        _restore(exp, ckpt_dir)
        ndc = None
        if exp.train_cfg.use_ndc:
            camera = exp.state.params.get("camera")
            if camera is not None:
                from scnerf_tpu_torch.camera.model import get_intrinsic

                K = get_intrinsic(camera).detach()
                fx, fy = float(K[0, 0]), float(K[1, 1])
            else:
                fx = fy = float(exp.noisy_focal)
            ndc = (exp.H, exp.W, fx, fy)
        params = {k: _detached(v) for k, v in exp.state.params.items() if k != "camera"}
        fn = make_nerf_serve_fn(params, exp.model_cfg, exp.render_cfg, ndc=ndc)
        specs = nerf_serve_specs(args.batch)
        meta = {
            "pipeline": "nerf",
            "inputs": ["rays_o (B,3) f32", "rays_d (B,3) f32",
                       "near (B,) f32", "far (B,) f32"],
            "outputs": ["rgb", "depth", "acc", "disp"],
            "ndc": list(ndc) if ndc else None,
        }

    data = export_serving_fn(fn, specs, path=out_path, device=device)
    operators = artifact_operators(torch.export.load(io.BytesIO(data)))
    library = str(_build.build("sample_pdf")) if operators else None
    meta.update(batch=args.batch, step=int(exp.state.step), bytes=len(data),
                expname=cfg.logging.expname, device=str(device), operator_library=library)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[export] step {meta['step']} -> {out_path} ({len(data) / 1e6:.1f} MB, "
          f"batch {args.batch}, {device})")
    if getattr(exp, "logger", None):
        exp.logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
