"""Every public top-level name of the JAX package has a counterpart in the
port, or is a recorded departure.

Each ``scnerf_tpu/**/*.py`` is read by its AST, without importing it, and
each public name it defines at the top level (functions, classes,
assignments not starting with ``_``) must be defined or imported at the
top level of the port's module of the same path (``kernels/*_pallas.py``
map to ``kernels/*_cuda.py``), or stand in :data:`DEPARTURES` with the
reason and the port's replacement. ``ROADMAP.md`` §3 holds the same table.
Every entry of the table must still be missing from the port, and each
replacement must exist there.
"""
import ast
from pathlib import Path

import pytest

from _torch_support import hang_watchdog  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "scnerf_tpu"
PORT_ROOT = REPO / "scnerf_tpu_torch"

MODULE_MAP = {
    "kernels/pdf_pallas.py": "kernels/pdf_cuda.py",
    "kernels/mlp_pallas.py": "kernels/mlp_cuda.py",
    "kernels/searchsorted_pallas.py": "kernels/searchsorted_cuda.py",
}

_OPTAX = "optax's chain is one multi-tensor Optimizer in the port"
_MASK = "masks are tuples of camera leaf names, not boolean pytrees"
_REMAT = "a remat variant (rematerialisation to fit TPU memory); the port runs the plain query"
_FUSE = "fuse_fgbg, a lever measured negative on the TPU, is not ported"
_TPU = "a TPU workaround; the port uses the GPU-native operator"
_XLA = "XLA machinery; the port runs eagerly"
_SHARDING = "a JAX sharding; the port places a rank's shard by hand"
_PYTREE = "JAX pytree machinery; the port's states are dataclasses of tensors"
_RNG = "JAX key machinery; the port draws from seeded torch.Generators"

# (JAX module, name) -> (reason, the port's replacement "module:Name[.attr]"
# or None where the port needs none).
DEPARTURES = {
    ("train/optim.py", "make_optimizer"): (_OPTAX, "train/optim.py:Optimizer.from_config"),
    ("train/optim.py", "exp_decay_schedule"): (_OPTAX, "train/optim.py:Optimizer.learning_rate"),
    ("train/optim.py", "clip_grads_elementwise"): (_OPTAX, "train/optim.py:Optimizer.update"),
    ("train/optim.py", "noise_decay_mask"): (_MASK, "train/optim.py:DECAYED_LEAVES"),
    ("train/optim.py", "camera_pose_mask"): (_MASK, "train/optim.py:CAMERA_POSE_LEAVES"),
    ("train/optim.py", "distortion_mask"): (_MASK, "train/optim.py:DISTORTION_LEAVES"),
    ("train/optim.py", "frozen_mask"): (_MASK, "camera/model.py:FROZEN_LEAVES"),
    ("train/curriculum.py", "mask_tree_camera_grads"):
        ("the gradients are a dict by leaf path, not a pytree",
         "train/curriculum.py:mask_camera_grads"),
    ("fields/nerf.py", "query_field_chunked"): (_REMAT, "fields/nerf.py:query_field"),
    ("fields/nerfpp.py", "mlpnet_apply_chunked"): (_REMAT, "fields/nerfpp.py:mlpnet_apply"),
    ("fields/nerfpp.py", "query_mlpnet_chunked"): (_REMAT, "fields/nerfpp.py:query_mlpnet"),
    ("fields/nerfpp.py", "stack_fgbg_params"): (_FUSE, None),
    ("fields/nerfpp.py", "query_fused_chunked"): (_FUSE, "fields/nerfpp.py:query_mlpnet"),
    ("sampling/pdf.py", "take_along_last"):
        (_TPU + " (torch.gather; the one-hot gather was for the TPU)", None),
    ("sampling/pdf.py", "sort_last_differentiable"):
        (_TPU + " (torch.sort, differentiable as it is)", None),
    ("train/profiling.py", "hlo_stats_rows"):
        (_XLA + " (no HLO)", "train/profiling.py:profile_rows"),
    ("serve.py", "enable_compilation_cache"): (_XLA + " (nothing is compiled)", None),
    ("distributed/mesh.py", "data_sharded"): (_SHARDING, "distributed/mesh.py:shard_batch"),
    ("distributed/mesh.py", "replicated"): (_SHARDING, "distributed/mesh.py:replicate_state"),
    ("distributed/mesh.py", "model_parallel_mlp_sharding"):
        ("no tensor-parallel layout: one card a process (make_mesh(n_model>1) raises)",
         "distributed/mesh.py:make_mesh"),
    **{("core/pytree.py", name): (_PYTREE, None)
       for name in ("pytree_dataclass", "static_field", "tree_map_with_path_names",
                    "tree_scale", "tree_select")},
    **{("core/rng.py", name): (_RNG, "train/driver.py:step_generator")
       for name in ("device_key", "fix_seeds", "step_key")},
    ("kernels/pdf_pallas.py", "sample_pdf_pallas_core"):
        ("K1, a CUDA kernel behind its wrapper", "kernels/pdf_cuda.py:sample_pdf_core"),
    ("kernels/pdf_pallas.py", "sample_pdf_pallas"):
        ("the caller draws u (sampling/pdf.py:pdf_uniforms) and calls K1",
         "kernels/pdf_cuda.py:sample_pdf_core"),
    ("kernels/pdf_pallas.py", "sample_pdf_pallas_diff"):
        ("K2 under its autograd function", "kernels/pdf_cuda.py:sample_pdf_diff"),
    ("kernels/searchsorted_pallas.py", "searchsorted_pallas"):
        ("K4, a CUDA kernel behind its wrapper", "kernels/searchsorted_cuda.py:searchsorted_cuda"),
}


def _module(rel: str) -> ast.Module:
    return ast.parse((PORT_ROOT / rel).read_text())


def public_names(tree: ast.Module) -> set:
    """The public names a module defines at its top level."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def top_level_names(tree: ast.Module) -> set:
    """The public names a module defines or imports at its top level."""
    names = public_names(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
    return names


def port_path(rel: str) -> str:
    return MODULE_MAP.get(rel, rel)


JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def test_the_walk_sees_the_package():
    assert len(JAX_MODULES) >= 60
    assert {"geometry/so3.py", "train/driver.py", "kernels/pdf_pallas.py"} <= set(JAX_MODULES)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    wanted = public_names(ast.parse((JAX_ROOT / rel).read_text()))
    target = PORT_ROOT / port_path(rel)
    have = top_level_names(ast.parse(target.read_text())) if target.exists() else set()
    missing = sorted(n for n in wanted - have if (rel, n) not in DEPARTURES)
    assert not missing, f"{rel}: no counterpart in scnerf_tpu_torch/{port_path(rel)}: {missing}"


@pytest.mark.parametrize("key", sorted(DEPARTURES), ids=lambda k: f"{k[0]}:{k[1]}")
def test_departure_is_real_and_replaced(key):
    """The name is public in the JAX module and absent from the port's, and
    the replacement (when there is one) exists in the port."""
    rel, name = key
    reason, replacement = DEPARTURES[key]
    assert reason
    assert name in public_names(ast.parse((JAX_ROOT / rel).read_text()))
    target = PORT_ROOT / port_path(rel)
    if target.exists():
        assert name not in top_level_names(ast.parse(target.read_text())), \
            f"{rel}:{name} is ported now; drop its departure"
    if replacement is None:
        return
    path, _, dotted = replacement.partition(":")
    head, _, attr = dotted.partition(".")
    tree = _module(path)
    assert head in top_level_names(tree), replacement
    if attr:
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == head)
        assert attr in {n.name for n in cls.body if isinstance(n, ast.FunctionDef)}, replacement
