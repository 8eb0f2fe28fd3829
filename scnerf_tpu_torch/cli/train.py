"""Training CLI of the port.

    python -m scnerf_tpu_torch.cli.train --config configs/llff/fern_ours.txt \
        [--device cuda|cpu] [--steps N] [--key value ...]

Port of ``scnerf_tpu/cli/train.py``: any reference flag can be overridden on
the command line (unknown flags warn instead of failing). ``--device``
(default ``cuda``) picks where the experiment runs; asking for ``cuda``
without a card exits with code 2.

- ``dataset_type llff`` and ``blender``: the NeRF driver. The run resumes
  from the latest checkpoint under ``basedir/expname/ckpts``, trains to
  ``--steps`` (else ``N_iters``) with a checkpoint every ``i_weights`` steps
  and one at the last step (which the JAX CLI does not save), and ends with
  the ATE-aligned test-view evaluation, printed as ``[eval] psnr=...
  ssim=...``.
- ``dataset_type nerfpp``: the NeRF++ driver (``run_nerfpp_training``),
  which, as the JAX one, does not resume and saves on ``i_weights`` steps
  only.
- ``--render_only`` renders instead of training (``cli/render.py``): the
  test split with ``--render_test``, else the render path; ``--device`` and
  the overrides go with it.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from scnerf_tpu_torch.core.config import _parse_value, _truthy, load_experiment


def parse_overrides(tokens: list[str]) -> dict:
    """``--key value`` tokens (a bare ``--flag`` is True) as config
    overrides."""
    overrides = {}
    k = None
    for tok in tokens:
        if tok.startswith("--"):
            k = tok[2:]
            overrides[k] = True  # bare flag
        elif k is not None:
            overrides[k] = _parse_value(tok)
            k = None
    return overrides


def override_tokens(overrides: dict) -> list[str]:
    """The inverse of :func:`parse_overrides`."""
    tokens = []
    for k, v in overrides.items():
        v = ",".join(map(str, v)) if isinstance(v, (list, tuple)) else str(v)
        tokens += [f"--{k}", v]
    return tokens


def parse_cli(argv=None):
    parser = argparse.ArgumentParser(description="scnerf-tpu trainer on PyTorch")
    parser.add_argument("--config", type=str, default=None, help="reference-style txt config")
    parser.add_argument("--steps", type=int, default=None, help="override N_iters")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    args, unknown = parser.parse_known_args(argv)
    return args, parse_overrides(unknown)


def device_or_exit(name: str, prog: str):
    """``torch.device(name)``, or None (after a message) for ``cuda``
    without a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return None
    return device


def main(argv=None):
    args, overrides = parse_cli(argv)
    # The reference's train-binary modes: --render_only renders instead of
    # training, --render_test picks the test split over the render path.
    if _truthy(overrides.pop("render_only", False)):
        from scnerf_tpu_torch.cli.render import main as render_main

        split = "test" if _truthy(overrides.pop("render_test", False)) else "path"
        return render_main(["--config", args.config, "--split", split, "--device", args.device]
                           + override_tokens(overrides))
    overrides.pop("render_test", None)
    device = device_or_exit(args.device, "scnerf_tpu_torch.cli.train")
    if device is None:
        return 2

    cfg = load_experiment(args.config, overrides)
    expdir = os.path.join(cfg.logging.basedir, cfg.logging.expname)
    if cfg.dataset.dataset_type == "nerfpp":
        from scnerf_tpu_torch.train.nerfpp_driver import run_nerfpp_training

        os.makedirs(expdir, exist_ok=True)
        run_nerfpp_training(cfg, expdir, n_steps=args.steps, device=device)
        return 0
    if cfg.dataset.dataset_type not in ("llff", "blender"):
        print(f"unknown dataset_type {cfg.dataset.dataset_type}", file=sys.stderr)
        return 1
    from scnerf_tpu_torch.train.checkpoint import list_checkpoint_steps, optim_knobs, save_checkpoint
    from scnerf_tpu_torch.train.driver import build_experiment, evaluate_test_views, train_loop

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
