"""Training CLI of the port.

    python -m scnerf_tpu_torch.cli.train --config configs/llff/fern_ours.txt \
        [--device cuda|cpu] [--steps N] [--key value ...]

Port of ``scnerf_tpu/cli/train.py`` for ``dataset_type llff``: any reference
flag can be overridden on the command line (unknown flags warn instead of
failing). ``--device`` (default ``cuda``) picks where the experiment runs;
asking for ``cuda`` without a card exits with code 2. The run resumes from
the latest checkpoint under ``basedir/expname/ckpts``, trains to ``--steps``
(else ``N_iters``) with a checkpoint every ``i_weights`` steps and one at the
last step (which the JAX CLI does not save), and ends with the ATE-aligned
test-view evaluation, printed as ``[eval] psnr=... ssim=...``.

Not in this slice: ``--render_only`` (``cli/render.py``) and the blender and
nerfpp datasets; they raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from scnerf_tpu_torch.core.config import _parse_value, _truthy, load_experiment


def parse_cli(argv=None):
    parser = argparse.ArgumentParser(description="scnerf-tpu trainer on PyTorch")
    parser.add_argument("--config", type=str, default=None, help="reference-style txt config")
    parser.add_argument("--steps", type=int, default=None, help="override N_iters")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    args, unknown = parser.parse_known_args(argv)
    overrides = {}
    k = None
    for tok in unknown:
        if tok.startswith("--"):
            k = tok[2:]
            overrides[k] = True  # bare flag
        elif k is not None:
            overrides[k] = _parse_value(tok)
            k = None
    return args, overrides


def main(argv=None):
    args, overrides = parse_cli(argv)
    if _truthy(overrides.pop("render_only", False)):
        raise NotImplementedError(
            "--render_only needs cli/render.py, which a later slice of the port brings")
    overrides.pop("render_test", None)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("scnerf_tpu_torch.cli.train: no CUDA device; pass --device cpu to train on "
              "the CPU", file=sys.stderr)
        return 2

    cfg = load_experiment(args.config, overrides)
    if cfg.dataset.dataset_type in ("blender", "nerfpp"):
        raise NotImplementedError(
            f"dataset_type {cfg.dataset.dataset_type} is not ported yet (a later slice of the "
            "port brings its loader and driver)")
    if cfg.dataset.dataset_type != "llff":
        print(f"unknown dataset_type {cfg.dataset.dataset_type}", file=sys.stderr)
        return 1
    from scnerf_tpu_torch.train.checkpoint import list_checkpoint_steps, optim_knobs, save_checkpoint
    from scnerf_tpu_torch.train.driver import build_experiment, evaluate_test_views, train_loop

    expdir = os.path.join(cfg.logging.basedir, cfg.logging.expname)
    os.makedirs(expdir, exist_ok=True)
    exp = build_experiment(cfg, expdir, device=device)
    n_steps = args.steps if args.steps is not None else cfg.optim.N_iters
    ckpt_dir = os.path.join(expdir, "ckpts")
    state, _ = train_loop(exp, n_steps, ckpt_dir=ckpt_dir)
    if state.step not in list_checkpoint_steps(ckpt_dir):
        # The last step too, so that the next call resumes where this one
        # ended (the JAX CLI saves on i_weights steps only).
        save_checkpoint(ckpt_dir, state, optim_meta=optim_knobs(cfg))
    results = evaluate_test_views(exp, max_views=3)
    print(f"[eval] psnr={results['psnr']:.2f} ssim={results['ssim']:.4f}")
    if exp.logger:
        exp.logger.log(state.step, {"final_" + k: v for k, v in results.items()})
        exp.logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
