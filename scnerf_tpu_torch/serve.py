"""Serving: fixed-batch render functions, portable artifacts of them, and a
service that pads requests onto them.

Port of ``scnerf_tpu/serve.py``. The serve functions
(:func:`make_nerf_serve_fn`, :func:`make_nerfpp_serve_fn`) bake in the
eval-path semantics: deterministic resampling and no jitter; for NeRF also
viewdirs from the world rays, the optional NDC warp with the learned focal
(near/far then 0/1), no sigma noise and the rgb clamp at 1. They run under
``inference_mode`` in full float32. The NeRF serve function queries its
fine field through K3 (``kernels/mlp_cuda.py``) where the kernel computes
it (weights float32 on a CUDA device, a config it supports), the weights
packed for it once, and its coarse field, and every field elsewhere,
through ``query_field``. The NeRF++ serve function does the same with its
last cascade level's fg and bg MLPNets (the 4-D bg points in the kernel's
4-D build), and queries level 0, and every field elsewhere, through
``query_mlpnet``.

:func:`export_serving_fn` writes a serve function as a ``torch.export``
artifact (``.pt2``) with its weights as constants, traced at a fixed batch
(:func:`nerf_serve_specs`, :func:`nerfpp_serve_specs`); K1, K2 and K3 stay
in it as calls of their registered operators. :func:`load_serving_fn` runs it
without the model code. :class:`RenderService` serves any request size
through a serve function or a loaded artifact, on one device or split over
the ranks of a process group.

The port runs eager, so the JAX package's ``enable_compilation_cache`` (a
persistent XLA cache for restarted workers) has no counterpart here, and the
service has no ``cost_analysis``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from scnerf_tpu_torch.train.profiling import count, span


def pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` copies of the last row (``np.pad(mode="edge")`` on
    axis 0)."""
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)


@contextlib.contextmanager
def fp32():
    """Full float32, as the JAX reference computes: TF32 off for matmuls
    and cuDNN for the block, the caller's flags restored after (TF32 keeps
    about three decimal digits). The serve functions and the train step run
    under it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def fp32_inference():
    """:func:`fp32` under ``inference_mode``: the serve functions'
    context."""
    with fp32(), torch.inference_mode():
        yield


def nerf_field_query(params: dict, model_cfg) -> Callable:
    """The NeRF serve function's field, ``query(mlp_params, model_cfg, pts,
    viewdirs) -> raw (N, S, 4)`` as ``render_rays`` calls it.

    The fine MLP's queries go through K3 where ``mlp_cuda.serves`` holds
    for its weights (float32 on a CUDA device, a config the kernel
    computes): it is packed here (``mlp_cuda.PackedWeights``), and again
    only after one of its leaves changed in place or was replaced, so the
    queries read the weights ``params`` holds. The coarse MLP's queries, and every query
    elsewhere (every CPU included), take ``query_field_fused``. The coarse
    field places the fine samples through the inverse CDF, which is
    steepest in the bins that hold only the eps weight: there a change of
    one float32 rounding in the coarse output moves a fine sample across
    much of the bin. So the coarse field keeps ``query_field``'s
    arithmetic, which the eval renders (``render_chunked``) and training
    share, bit for bit: ``query_field_fused`` only leaves out its ReLU and
    concatenation passes. While a profiler records, each query adds its
    points to the counter ``serve.field_points``, and to
    ``serve.field_points_k3`` when it goes through K3 or to
    ``serve.field_points_fused`` when it goes through the twin.
    """
    from scnerf_tpu_torch.fields.nerf import query_field_fused
    from scnerf_tpu_torch.kernels import mlp_cuda

    fine = params.get("fine")
    pack = None
    if fine is not None and mlp_cuda.serves(model_cfg, fine["pts"][0]["w"].device,
                                            fine["pts"][0]["w"].dtype):
        pack = mlp_cuda.PackedWeights(fine, model_cfg)
        pack.get()  # at the build, not in the first request

    def query(mlp, cfg, pts, viewdirs):
        n = pts.shape[0] * pts.shape[1]
        count("serve.field_points", n)
        if pack is None or mlp is not fine:
            count("serve.field_points_fused", n)
            return query_field_fused(mlp, cfg, pts, viewdirs)
        count("serve.field_points_k3", n)
        return mlp_cuda.fused_query_field(mlp, cfg, pts.contiguous(), viewdirs.contiguous(),
                                          packed=pack.get())

    return query


def make_nerf_serve_fn(
    params: dict,
    model_cfg,
    render_cfg,
    *,
    ndc: tuple | None = None,
    outputs: Sequence[str] = ("rgb", "depth", "acc", "disp"),
) -> Callable:
    """Build ``fn(rays_o, rays_d, near, far) -> {maps}``.

    Args:
      params: ``{"coarse": ..., "fine": ...}`` on the device the rays will
        come on (closed over).
      ndc: optional ``(H, W, fx, fy)``: warp the world rays into NDC with
        this focal before rendering; near/far become 0/1.
      outputs: which maps to return.

    The fields go through :func:`nerf_field_query`, so on the card the
    fine weights are packed for K3 here, at the build.
    """
    from scnerf_tpu_torch.geometry.ndc import ndc_rays
    from scnerf_tpu_torch.render.renderer import render_rays

    eval_cfg = render_cfg.eval_mode()
    query = nerf_field_query(params, model_cfg)

    def fn(rays_o, rays_d, near, far):
        with fp32_inference():
            viewdirs = None
            if eval_cfg.use_viewdirs:
                viewdirs = rays_d / (
                    torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True) + 1e-10)
            if ndc is not None:
                H, W, fx, fy = ndc
                rays_o, rays_d = ndc_rays(H, W, fx, fy, 1.0, rays_o, rays_d)
                near = torch.zeros_like(near)
                far = torch.ones_like(far)
            out = render_rays(params, model_cfg, eval_cfg, rays_o, rays_d, viewdirs,
                              near, far, query=query)
            out["rgb"] = torch.clamp(out["rgb"], max=1.0)
            return {k: out[k] for k in outputs}

    return fn


NERFPP_OUTPUTS = ("rgb", "fg_depth", "bg_lambda")


def nerfpp_field_query(level_params: list, model_cfg) -> Callable:
    """The NeRF++ serve function's fields, ``query(mlpnet_params, model_cfg,
    pts, views_enc, input_dim) -> (rgb, sigma)`` as ``nerfpp_forward`` calls
    them.

    The last cascade level's fg and bg MLPNets go through K3 where
    ``mlp_cuda.serves`` holds for their weights (float32 on a CUDA device, a
    config the kernel computes), each packed here once for its point width
    (fg 3, bg 4) and again only after one of its leaves changed; the kernel
    takes the view directions, which are the first three columns of
    ``views_enc``, and returns the raw heads, to which ``abs`` (sigma) and
    a sigmoid (rgb) are applied here as ``mlpnet_apply`` applies them. The
    earlier levels place the later levels' samples through K2's inverse CDF
    (``nerf_field_query`` says why that keeps them on the plain
    arithmetic), so they, and every query elsewhere (every CPU included),
    take ``query_mlpnet_fused``, ``query_mlpnet``'s inference twin with the
    same bits. While a profiler records, each query adds its points to the
    counter ``serve.field_points``, and to ``serve.field_points_k3`` when it
    goes through K3 or to ``serve.field_points_fused`` when it goes through
    the twin.
    """
    from scnerf_tpu_torch.fields.nerf import NeRFConfig
    from scnerf_tpu_torch.fields.nerfpp import query_mlpnet_fused
    from scnerf_tpu_torch.kernels import mlp_cuda

    kernel_cfg = NeRFConfig(depth=model_cfg.depth, width=model_cfg.width,
                            skips=tuple(model_cfg.skips), multires=model_cfg.max_freq_log2,
                            multires_views=model_cfg.max_freq_log2_viewdirs)
    packs = []  # (MLPNet, its PackedWeights)
    for name, dim in (("fg", 3), ("bg", 4)):
        mlp = level_params[-1][name]
        w = mlp["base"][0]["w"]
        if mlp_cuda.serves(kernel_cfg, w.device, w.dtype):
            packs.append((mlp, mlp_cuda.PackedWeights(mlp, kernel_cfg, dim)))
            packs[-1][1].get()  # at the build, not in the first request

    def query(mlp, cfg, pts, views_enc, input_dim):
        n = pts.shape[0] * pts.shape[1]
        count("serve.field_points", n)
        pack = next((p for m, p in packs if m is mlp), None)
        if pack is None:
            count("serve.field_points_fused", n)
            return query_mlpnet_fused(mlp, cfg, pts, views_enc, input_dim)
        count("serve.field_points_k3", n)
        raw = mlp_cuda.fused_query_field(mlp, kernel_cfg, pts.contiguous(),
                                         views_enc[:, :3].contiguous(), packed=pack.get())
        return torch.sigmoid(raw[..., :3]), torch.abs(raw[..., 3])

    return query


def make_nerfpp_serve_fn(level_params: list, model_cfg, render_cfg) -> Callable:
    """Build ``fn(ray_o, ray_d, min_depth) -> {maps}``: the last cascade
    level's ``NERFPP_OUTPUTS``, as the JAX package's NeRF++ serve function
    returns by default.

    Args:
      level_params: one ``{"fg", "bg"}`` param dict per cascade level, on
        the device the rays will come on (closed over).

    The fields go through :func:`nerfpp_field_query`, so on the card the
    last level's weights are packed for K3 here, at the build.
    """
    from scnerf_tpu_torch.render.nerfpp_renderer import render_rays_nerfpp

    eval_cfg = dataclasses.replace(render_cfg, perturb=False)
    query = nerfpp_field_query(level_params, model_cfg)

    def fn(ray_o, ray_d, min_depth):
        with fp32_inference():
            last = render_rays_nerfpp(level_params, model_cfg, eval_cfg, ray_o, ray_d,
                                      min_depth, query=query)[-1]
            return {k: last[k] for k in NERFPP_OUTPUTS}

    return fn


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one argument of a serve function."""

    shape: tuple
    dtype: torch.dtype = torch.float32


def nerf_serve_specs(batch: int) -> tuple:
    """``rays_o (B, 3)``, ``rays_d (B, 3)``, ``near (B,)``, ``far (B,)``,
    float32."""
    return (TensorSpec((batch, 3)), TensorSpec((batch, 3)), TensorSpec((batch,)),
            TensorSpec((batch,)))


def nerfpp_serve_specs(batch: int) -> tuple:
    """``ray_o (B, 3)``, ``ray_d (B, 3)``, ``min_depth (B,)``, float32."""
    return TensorSpec((batch, 3)), TensorSpec((batch, 3)), TensorSpec((batch,))


class _Served(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def random_operators(program) -> list[str]:
    """The operators of an exported program's graph that draw random
    numbers (PyTorch tags them ``nondeterministic_seeded``)."""
    return sorted({str(node.target) for node in program.graph.nodes
                   if node.op == "call_function"
                   and torch.Tag.nondeterministic_seeded in getattr(node.target, "tags", ())})


def export_serving_fn(fn: Callable, specs: Sequence[TensorSpec], path: str | None = None, *,
                      device: torch.device | str = "cuda") -> bytes:
    """Export ``fn`` at ``specs`` with ``torch.export`` (non-strict) and return
    the artifact's bytes, also written to ``path`` when given.

    ``fn``'s weights, closed over, become the program's constants. Its
    arguments are traced on ``device``, where the weights must lie: a CUDA
    artifact keeps its constants on the card (the NeRF serve function's
    packed K3 weights among them), and K1, K2 and K3 stay in it as calls of
    ``torch.ops.scnerf_tpu_torch.*`` (traced by their fake
    implementations). Raises ``RuntimeError`` if the graph draws random
    numbers: serving is deterministic.
    """
    args = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device) for s in specs)
    program = torch.export.export(_Served(fn), args, strict=False)
    drawn = random_operators(program)
    if drawn:
        raise RuntimeError(f"the exported serve function draws random numbers: {drawn}")
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    data = buffer.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def artifact_operators(program) -> list[str]:
    """The port's registered operators (K1, K2, K3 and ``dense_into``) that
    an exported program calls."""
    from scnerf_tpu_torch.kernels import pdf_cuda

    prefix = pdf_cuda.OPS_NAMESPACE + "."
    return sorted({str(node.target) for node in program.graph.nodes
                   if node.op == "call_function" and str(node.target).startswith(prefix)})


def artifact_device(program) -> torch.device:
    """The device an exported program's inputs were traced on."""
    for node in program.graph.nodes:
        if node.op == "placeholder" and isinstance(node.meta.get("val"), torch.Tensor):
            return node.meta["val"].device
    raise ValueError("the exported program has no tensor input")


def load_serving_fn(path_or_bytes) -> Callable:
    """Load an artifact of :func:`export_serving_fn`; returns
    ``fn(*tensors) -> {maps}``.

    Needs only torch and the kernel modules, none of the model code:
    importing ``kernels/pdf_cuda.py``, ``kernels/mlp_cuda.py`` and
    ``kernels/dense_lt.py`` registers the schemas and the CUDA
    implementations of K1's, K2's and K3's operators and of ``dense_into``,
    whose plain-C libraries load at their first launch. A CUDA
    artifact needs a card to load.
    Each call runs under :func:`fp32_inference`, since export does not
    record the TF32 flags, and restores the caller's after. ``fn.exported``
    is the ``ExportedProgram``, ``fn.operators`` the operators it calls.
    """
    from scnerf_tpu_torch.kernels import dense_lt, mlp_cuda, pdf_cuda  # noqa: F401 (the operators)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(bytes(path_or_bytes))
    program = torch.export.load(path_or_bytes)
    operators = artifact_operators(program)
    module = program.module()

    def fn(*args):
        with fp32_inference():
            return module(*args)

    fn.exported = program
    fn.operators = operators
    fn.module = module
    return fn


class RenderService:
    """Serves ray batches of any size through a fixed-batch serve function.

    A request is moved to ``device`` as float32, edge-padded to a multiple of
    ``batch`` and run slice by slice; slices queue on the device without a
    host sync, and the maps come back to the host once, as numpy.

    With a process ``group`` (the JAX service's ``mesh=``), each rank renders
    its contiguous share of every slice, ``batch // world`` rays, so ``fn``
    takes that many (an artifact is exported at the share), and an
    ``all_gather`` hands every rank the whole result. A ``batch`` that the
    group's size does not divide raises ``ValueError``. The JAX service's
    ``cost_analysis`` is XLA's and has no counterpart.

    While a profiler records, a call is the span ``scnerf.serve.request``
    (numbered by the service), with ``upload``, ``slices`` and ``readback``
    inside it, and adds the rays requested and the rays run, padding
    included, to the counters ``serve.rays`` and ``serve.rays_run``.
    """

    def __init__(self, fn: Callable, batch: int, *, device: torch.device | str = "cuda",
                 group=None):
        self.fn = fn
        self.batch = batch
        self.device = torch.device(device)
        self.group = group
        self.world, self.rank = 1, 0
        if group is not None:
            import torch.distributed as dist

            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
            if batch % self.world:
                raise ValueError(f"batch {batch} not divisible by the group's size "
                                 f"{self.world}")
        self.share = batch // self.world
        self._requests = itertools.count()

    def _gather(self, out: dict) -> dict:
        import torch.distributed as dist

        whole = {}
        for k in sorted(out):
            parts = [torch.empty_like(out[k]) for _ in range(self.world)]
            dist.all_gather(parts, out[k].contiguous(), group=self.group)
            whole[k] = torch.cat(parts)
        return whole

    def __call__(self, *arrays) -> dict[str, np.ndarray]:
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty request")
        b = self.batch
        n_slices = -(-n // b)
        pad = n_slices * b - n
        count("serve.rays", n)
        count("serve.rays_run", n_slices * b)
        with span("scnerf.serve.request", next(self._requests)):
            with span("scnerf.serve.upload"):
                padded = [
                    pad_edge(torch.as_tensor(x, dtype=torch.float32).to(self.device), pad)
                    for x in arrays
                ]
            lo = self.rank * self.share
            outs = []
            with span("scnerf.serve.slices"):
                for i in range(n_slices):
                    out = self.fn(*(x[i * b + lo:i * b + lo + self.share] for x in padded))
                    outs.append(out if self.group is None else self._gather(out))
            # The copy to the host waits for the card.
            with span("scnerf.serve.readback"):
                return {k: torch.cat([o[k] for o in outs])[:n].cpu().numpy() for k in outs[0]}
