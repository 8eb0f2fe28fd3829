"""What the training drivers share: the seeded leaves, the recorder of the
checked steps, the measured window and the comparison with the reference.

The comparison follows the first ``checked_steps`` steps of the set-up,
which run through the window's own call and feed. Per leaf, two gaps are
taken: of the first step's gradient as the optimizer got it, worked out
from Adam's first moment after that step (``mu / (1 - b1)``; the moments
start at zero), and of each leaf's change over the steps; each gap of norms
``|n - n_ref|`` over the larger of the reference's norm of that leaf and of
the median leaf of its group. The leaves fall into groups, one for each
net and one for the camera (:func:`group_of`), so that the camera's few
small leaves are judged against their own scale. Leaves whose reference
gradient is below a thousandth of the median leaf's are left out of the
change (their updates are round-off under Adam). Five numbers are
compared:

- ``loss1_gap``: ``|loss - loss_ref| / |loss_ref|`` of the first step;
- ``grad_group_gap`` and ``change_group_gap``: the largest over the groups
  of the group's median gap;
- ``frozen_moved``: the leaves that the reference leaves exactly as they
  were over the checked steps (a camera masked by the curriculum) and the
  program moves (limit 0);
- ``draw_faults``: the steps whose batch the program drew wrong (limit 0):
  in the window, each batch of another size than ``N_rand``; in the
  checked steps and every 16th window step, each batch of another size, or
  whose pixels lie outside the image, repeat, repeat the last checked
  batch's, or do not spread over the image (and, where each ray names its
  image, over the images) as a uniform draw does. The reference follows
  the program's own draws, so a short or skewed draw would pass the other
  numbers; the window's rate counts the rays actually drawn.

The largest gap over the steps' losses and over the leaves swing by an
order of magnitude from seed to seed (later steps and small leaves move by
Adam's near-sign updates of near-zero gradients); :func:`widest` records
them beside the compared numbers.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from portbench.harness import device_info, host_report, host_usage
from portbench.metrics.peaks import FP32_FLOP_PER_S, TF32_FLOP_PER_S
from portbench.trace import traced

GAIN_RELU = math.sqrt(2.0)
BIAS_AMPLITUDE = 0.05
CAMERA_LEAVES = ("intrinsics_noise", "extrinsics_noise", "distortion_noise", "ray_o_grid",
                 "ray_d_grid")
NEGLIGIBLE_GRAD = 1e-3
DRAW_SIGMAS = 6.0  # how far a uniform draw's pixel mean and spread may stray


def seeded_leaves(shapes: dict[str, tuple], seed: int, camera_noise: dict,
                  device) -> dict[str, torch.Tensor]:
    """A value for each trainable leaf (by path), drawn uniformly on the
    device from one generator in one call, in path order: a weight ``w``
    ``(fan_in, fan_out)`` within the ReLU-gain Xavier limit, a bias within
    :data:`BIAS_AMPLITUDE`, a camera leaf within the mix's amplitude for it
    (0 where the mix names none: the leaf's initial value)."""
    paths = sorted(shapes)
    total = sum(math.prod(shapes[p]) for p in paths)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, offset = {}, 0
    for path in paths:
        shape = shapes[path]
        name = path.rsplit("/", 1)[-1]
        if name == "w":
            amplitude = GAIN_RELU * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif name == "b":
            amplitude = BIAS_AMPLITUDE
        elif name in CAMERA_LEAVES:
            amplitude = camera_noise.get(name, 0.0)
        else:
            raise ValueError(f"no rule for the trainable leaf {path} of shape {shape}")
        n = math.prod(shape)
        out[path] = flat[offset:offset + n].view(shape) * amplitude
        offset += n
    return out


@torch.no_grad()
def write_leaves(leaves: dict[str, torch.Tensor], values: dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into ``leaves`` in place; both must name the same
    paths with the same shapes."""
    if set(leaves) != set(values):
        raise ValueError(f"leaves differ: {sorted(set(leaves) ^ set(values))}")
    for path, x in leaves.items():
        x.copy_(values[path])


class Recorder:
    """Wraps an experiment's step functions for its first ``n`` steps: keeps
    each step's batch and metrics, Adam's first moment after the first step
    and the trainable leaves after the last."""

    def __init__(self, exp, n: int, trainable_leaves):
        self.exp, self.n, self.leaves_of = exp, n, trainable_leaves
        self.calls, self.mu1, self.after = [], None, None  # each call: batch, metrics
        self.fns = exp.step_fn, exp.step_prd_fn
        exp.step_fn = self._wrap(exp.step_fn)
        if exp.step_prd_fn is not None:
            exp.step_prd_fn = self._wrap(exp.step_prd_fn)

    def _wrap(self, fn):
        def call(state, batch, generator):
            state, metrics = fn(state, batch, generator)
            self.calls.append({"batch": dict(batch), "metrics": metrics})
            if len(self.calls) == 1:
                self.mu1 = {k: v.detach().clone() for k, v in state.opt_state.mu.items()}
            if len(self.calls) == self.n:
                self.after = {k: v.detach().clone()
                              for k, v in self.leaves_of(state.params).items()}
            return state, metrics
        return call

    def detach(self) -> None:
        """Put the experiment's own step functions back."""
        self.exp.step_fn, self.exp.step_prd_fn = self.fns
        self.exp = None
        if len(self.calls) != self.n:
            raise RuntimeError(f"{len(self.calls)} steps recorded, {self.n} asked for")


class Tally:
    """Wraps an experiment's step functions through the window: counts the
    rays of every batch and the batches of another size than ``n_rand``,
    and keeps the pixel draw of every ``every``-th step."""

    def __init__(self, exp, n_rand: int, every: int):
        self.exp, self.n_rand, self.every = exp, n_rand, every
        self.rays, self.steps, self.wrong_size, self.draws = 0, 0, 0, []
        self.fns = exp.step_fn, exp.step_prd_fn
        exp.step_fn = self._wrap(exp.step_fn)
        if exp.step_prd_fn is not None:
            exp.step_prd_fn = self._wrap(exp.step_prd_fn)

    def _wrap(self, fn):
        def call(state, batch, generator):
            n = batch["px"].shape[0]
            self.rays += n
            self.wrong_size += n != self.n_rand
            if self.steps % self.every == 0:
                self.draws.append(draw_of(batch))
            self.steps += 1
            return fn(state, batch, generator)
        return call

    def detach(self) -> None:
        self.exp.step_fn, self.exp.step_prd_fn = self.fns
        self.exp = None


def draw_of(batch: dict) -> tuple:
    """A batch's pixel draw: ``px``, ``py`` and ``img_idx`` (per ray, or
    0-d where the batch is one image's)."""
    return batch["px"], batch["py"], batch["img_idx"]


def _uniform(x: np.ndarray, extent: int) -> bool:
    """Whether ``n`` pixel coordinates ``x`` in ``[0, extent)`` spread as a
    uniform draw's do, within :data:`DRAW_SIGMAS` of their standard errors:
    the mean near the middle (error ``extent / sqrt(12 n)``), the standard
    deviation near ``extent / sqrt(12)`` (relative error ``sqrt(0.2 / n)``,
    a uniform's kurtosis being 1.8)."""
    n, sd = len(x), extent / math.sqrt(12.0)
    centre = abs(x.mean() + 0.5 - extent / 2) / (sd / math.sqrt(n))
    spread = abs(x.std() / sd - 1.0) / math.sqrt(0.2 / n)
    return centre <= DRAW_SIGMAS and spread <= DRAW_SIGMAS


def draw_faults(draws: list, n_rand: int, H: int, W: int, n_images: int) -> int:
    """The draws (``(px, py, img_idx)``, in step order) that a sound pixel
    draw of ``n_rand`` distinct pixels, uniform over ``n_images`` images of
    ``H x W``, cannot give."""
    faults, last = 0, None
    for px, py, img in draws:
        px, py = (t.detach().double().cpu().numpy() for t in (px, py))
        img = img.detach().cpu().numpy()
        ok = (px.shape == (n_rand,) and py.shape == (n_rand,)
              and (img.ndim == 0 or img.shape == (n_rand,)))
        if ok:
            imgs = np.broadcast_to(img, px.shape).astype(np.int64)
            ok = bool(np.all(px == np.round(px)) and np.all(py == np.round(py))
                      and px.min() >= 0 and px.max() < W and py.min() >= 0 and py.max() < H
                      and imgs.min() >= 0 and imgs.max() < n_images)
        if ok:
            key = (imgs * H + py.astype(np.int64)) * W + px.astype(np.int64)
            ok = (len(np.unique(key)) == n_rand and _uniform(px, W) and _uniform(py, H)
                  and (img.ndim == 0 or len(np.unique(img)) >= min(n_images, n_rand) // 2)
                  and (last is None or len(np.intersect1d(key, last)) <= n_rand // 2))
            last = key
        faults += not ok
    return faults


def sync(device) -> None:
    """Wait for ``device`` (a CUDA card; the CPU has nothing to wait for)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(call, seconds: float, step_of, prd_at, events: bool, device) -> dict:
    """Call ``call()`` (one step) until ``seconds`` have passed on the host
    clock, then synchronise. Each call's host milliseconds are kept and,
    with ``events``, the milliseconds between CUDA events recorded around
    each PRD step."""
    spans, pairs, prd_steps = [], [], 0
    sync(device)
    t0 = time.perf_counter()
    while True:
        prd = prd_at(step_of())
        if events:
            before = torch.cuda.Event(enable_timing=True)
            before.record()
        start = time.perf_counter()
        call()
        end = time.perf_counter()
        if events:
            after = torch.cuda.Event(enable_timing=True)
            after.record()
            if prd:
                pairs.append((before, after))
        spans.append((end - start) * 1e3)
        prd_steps += prd
        if end - t0 >= seconds:
            break
    sync(device)
    t1 = time.perf_counter()
    return {"seconds": t1 - t0, "steps": len(spans), "prd_steps": prd_steps,
            "spans_ms": spans, "prd_ms": [a.elapsed_time(b) for a, b in pairs]}


def _norms(tree: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _relative(got: dict[str, float], want: dict[str, float], keep) -> dict[str, float]:
    """Each leaf's ``|got - want|`` over ``max(want, median want)`` among the
    leaves ``keep``, the median taken in the leaf's group (over all leaves
    where the group's reads 0, as a masked camera's does)."""
    groups: dict[str, list[float]] = {}
    for k in keep:
        groups.setdefault(group_of(k), []).append(want[k])
    median = {g: statistics.median(v) for g, v in groups.items()}
    overall = statistics.median(want[k] for k in keep)
    return {k: abs(got[k] - want[k]) / (max(want[k], median[group_of(k)]) or overall)
            for k in keep}


def group_of(path: str) -> str:
    """The group of a leaf: its net or the camera, by the path's first
    name, with the index and name after it where the first name holds a
    list of nets (``"coarse"``, ``"camera"``, ``"levels/1/bg"``)."""
    parts = path.split("/")
    n = 1
    while n + 1 < len(parts) and parts[n].isdigit():
        n += 2
    return "/".join(parts[:n])


def leaf_gaps(program: dict, reference: dict, b1: float) -> tuple[dict, dict]:
    """Each leaf's gap of first-gradient norms, and each kept leaf's gap of
    change norms."""
    grads = _norms({k: v / (1.0 - b1) for k, v in program["mu1"].items()})
    grads_ref = _norms({k: v / (1.0 - b1) for k, v in reference["mu1"].items()})
    median = statistics.median(grads_ref.values())
    keep = [k for k in grads_ref if grads_ref[k] >= NEGLIGIBLE_GRAD * median]
    change = _norms({k: program["after"][k] - program["before"][k] for k in keep})
    change_ref = _norms({k: reference["after"][k] - reference["before"][k] for k in keep})
    return _relative(grads, grads_ref, list(grads_ref)), _relative(change, change_ref, keep)


def group_medians(gaps: dict[str, float]) -> dict[str, float]:
    """The median gap of each group's leaves."""
    groups: dict[str, list[float]] = {}
    for k, v in gaps.items():
        groups.setdefault(group_of(k), []).append(v)
    return {g: statistics.median(v) for g, v in sorted(groups.items())}


def readings(program: dict, reference: dict, b1: float) -> dict[str, float]:
    """The compared numbers of a program's record against the reference's
    (but ``draw_faults``): both ``{"losses": [...], "mu1": {...}, "before":
    {...}, "after": {...}}``."""
    if len(program["losses"]) != len(reference["losses"]):
        return {"loss1_gap": math.inf, "grad_group_gap": math.inf,
                "change_group_gap": math.inf, "frozen_moved": math.inf}
    grad, change = leaf_gaps(program, reference, b1)
    loss1 = abs(program["losses"][0] - reference["losses"][0]) / abs(reference["losses"][0])
    frozen = [k for k in reference["after"]
              if torch.equal(reference["after"][k], reference["before"][k])]
    moved = sum(not torch.equal(program["after"][k], program["before"][k]) for k in frozen)
    return {"loss1_gap": loss1, "grad_group_gap": max(group_medians(grad).values()),
            "change_group_gap": max(group_medians(change).values()),
            "frozen_moved": float(moved)}


def widest(program: dict, reference: dict, b1: float) -> dict:
    """Each group's median gaps, and the largest gaps (over the steps'
    losses, and over the leaves with the leaf that sets each), recorded
    beside the compared numbers."""
    grad, change = leaf_gaps(program, reference, b1)
    losses = zip(program["losses"], reference["losses"])
    return {"grad_groups": group_medians(grad), "change_groups": group_medians(change),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in losses),
            "grad_gap": max(grad.values()), "grad_leaf": max(grad, key=grad.get),
            "change_gap": max(change.values()), "change_leaf": max(change, key=change.get)}


def checks(values: dict[str, float], limits: dict) -> dict:
    """``{name: {"value", "limit"}}``; a reading that is not finite is
    reported as 1e30."""
    return {k: {"value": v if math.isfinite(v) else 1e30, "limit": limits[k]}
            for k, v in values.items()}


def program_record(prep: dict) -> dict:
    """The program's side of the comparison, from the set-up's recorder:
    its losses, first moment and leaves, and the seeded leaves it began
    from."""
    rec = prep["recorder"]
    return {"losses": [float(c["metrics"]["loss"]) for c in rec.calls], "mu1": rec.mu1,
            "before": prep["weights"], "after": rec.after}


def measure(run, prep: dict, prd_at, *, ray_flops: int, operator: str,
            operator_bytes: int, reference_record) -> dict:
    """A training cell after its set-up: the window (its rays counted from
    the batches drawn), the traced segment (``--trace 1``;
    ``operator_bytes`` of ``operator`` a step), the program's state freed,
    then the draws' check and the reference over the checked steps."""
    flags, exp, call = prep["flags"], prep["exp"], prep["call"]
    n_rand = flags["N_rand"]
    tally = Tally(exp, n_rand, every=16)
    usage = host_usage()
    w = window(call, run.seconds, lambda: exp.state.step, prd_at, run.trace, run.device)
    host = host_report(usage, host_usage(), w["seconds"])
    tally.detach()
    w["rays"] = tally.rays
    w["flops"] = ray_flops * tally.rays
    rays_per_s = tally.rays / w["seconds"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    print(f"window: {w['steps']} steps ({w['prd_steps']} with PRD) in {w['seconds']:.3f} s, "
          f"{tally.rays} rays, {rays_per_s:.1f} rays/s; model FLOPs {ray_flops} a ray; "
          f"against the float32 peak {w['flops'] / w['seconds'] / FP32_FLOP_PER_S:.3%}, "
          f"against TF32 {w['flops'] / w['seconds'] / TF32_FLOP_PER_S:.3%}; peak memory "
          f"{peak} bytes; host ms a call p10/p50/p90/max "
          f"{'/'.join(f'{q:.2f}' for q in np.percentile(w['spans_ms'], [10, 50, 90, 100]))}"
          f"; {host}", flush=True)
    trace = None
    if run.trace:
        n = run.mix["traced_steps"]
        trace = traced(lambda: [call() for _ in range(n)], run.tmpdir)
        trace["units"] = n
        trace["op_bytes"] = {operator: n * operator_bytes}
        print(f"traced: {n} steps, {trace['kernels']} kernels, {trace['kernel_s']:.6f} s of "
              f"device time in {trace['window_s']:.6f} s, busy {trace['busy_s']:.6f} s; "
              f"{operator_bytes} bytes a step and {trace['op_device_s'].get(operator)} s "
              f"under {operator}", flush=True)
    program = program_record(prep)
    prep["calls"] = prep.pop("recorder").calls
    draws = [draw_of(c["batch"]) for c in prep["calls"]] + tally.draws
    faults = tally.wrong_size + draw_faults(draws, n_rand, **prep["draw"])
    print(f"draws: {tally.steps} window steps, {tally.wrong_size} of another size than "
          f"{n_rand}; {len(draws)} draws checked", flush=True)
    prep["exp"] = prep["call"] = exp = call = tally = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_record(prep, run.device)
    values = {**readings(program, reference, reference["b1"]), "draw_faults": float(faults)}
    return {"end_to_end": {f"{run.mix['scope']}_rays_per_s": rays_per_s},
            "window": w, "trace": trace, "attempted": w["steps"], "failed": 0,
            "device": device_info(run.device, peak), "checks": checks(values, run.limits)}
