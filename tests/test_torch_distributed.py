"""The port's data parallelism (``scnerf_tpu_torch/distributed``) on two gloo
ranks on the CPU, and its placement rules against the JAX package's.

- ``make_mesh``, ``pad_to_multiple`` and ``shard_batch`` against
  ``scnerf_tpu.distributed.mesh`` on the same inputs (a JAX mesh of two of
  the forced CPU devices): every rank's part equal to the JAX array's shard
  on that device, the same keys sharded and replicated, the same refusal
  without padding.
- Two ranks, launched once for the module as subprocesses of this file
  (``python tests/test_torch_distributed.py --rank R ...``), joined through a
  ``FileStore`` under the test's temporary directory (no port to collide
  on under xdist) with a 60 s group timeout; the launch is killed after
  ``LAUNCH_TIMEOUT_S``. Each rank runs every scenario below and writes its
  results; the tests compare them with the single-process port step on the
  same state and the same (padded) global batch, computed here:

  - a NeRF step with PRD on a 63-ray batch and 7 matches (both padded to
    even by ``shard_batch``, as JAX's padded step counts the duplicated
    rows): the loss within relative 1e-5 and every parameter within 1e-5,
    as ``tests/test_distributed.py:78``; the gradients every rank hands its
    optimizer, the camera's included, bit-equal across ranks;
  - a NeRF++ step with pixel rays from the camera (K2's backward on each
    rank, counted), a per-ray mask and PRD, at the same limits;
  - ``RenderService(group=)`` against the single-device service at a
    ragged request size;
  - a 4-step trajectory with a checkpoint written by rank 0 after step 2
    and restored by every rank, against the uninterrupted 4 steps
    (bit-equal) and the single-process trajectory (1e-5);
  - ``replicate_state`` making rank 1's perturbed state rank 0's, and
    ``initialize_runtime``'s topology.

Every rank takes its slice of the global batch's injected draws
(``rands``), so both runs see the same numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu_torch.camera.model import CameraConfig, OPENCV, init_camera  # noqa: E402
from scnerf_tpu_torch.camera.model import trainable_camera  # noqa: E402
from scnerf_tpu_torch.distributed import mesh as tmesh  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp  # noqa: E402
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_nerfpp_net  # noqa: E402
from scnerf_tpu_torch.render.nerfpp_renderer import NerfPPRenderConfig  # noqa: E402
from scnerf_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from scnerf_tpu_torch.train.curriculum import Curriculum  # noqa: E402
from scnerf_tpu_torch.train.nerfpp_step import NerfPPTrainConfig  # noqa: E402
from scnerf_tpu_torch.train.nerfpp_step import make_nerfpp_train_step  # noqa: E402
from scnerf_tpu_torch.train.optim import Optimizer, named_leaves  # noqa: E402
from scnerf_tpu_torch.train.step import TrainConfig, create_train_state  # noqa: E402
from scnerf_tpu_torch.train.step import make_train_step  # noqa: E402

WORLD = 2
GROUP_TIMEOUT_S = 60
LAUNCH_TIMEOUT_S = 240
RTOL = 1e-5

H, W = 16, 16
N_IMAGES = 2
N_RAND = 63  # odd: shard_batch pads it to 64 on two ranks
N_MATCH = 7
NERF_MODEL = NeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
NERF_RENDER = RenderConfig(n_samples=8, n_importance=8, perturb=True, raw_noise_std=1.0)
PP_MODEL = NerfPPConfig(depth=3, width=32, skips=(1,), max_freq_log2=4, max_freq_log2_viewdirs=2)
PP_RENDER = NerfPPRenderConfig(cascade_samples=(8, 8), perturb=True)
TRAJECTORY_STEPS = 4
CKPT_AFTER = 2


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _poses(opencv=False):
    E = np.tile(np.eye(4), (N_IMAGES, 1, 1))
    E[1, :3, :3] = _rotation([0.1, 1.0, 0.0], 0.25 if not opencv else -0.15)
    E[1, :3, 3] = [1.0, 0.0, 0.1] if not opencv else [0.4, 0.0, 0.05]
    return E


def _K(focal):
    return np.array([[focal, 0, W / 2, 0], [0, focal, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def _camera(opencv, seed):
    """A learnable camera with every learnable leaf drawn off zero."""
    rng = np.random.default_rng(seed)
    cfg = (CameraConfig(H=H, W=W, grid_size=4, convention=OPENCV, pixel_offset=0.5,
                        multiplicative_noise=True) if opencv
           else CameraConfig(H=H, W=W, grid_size=4))
    cam = init_camera(_K(20.0), _poses(opencv), cfg, device="cpu")
    scale = dict(intrinsics_noise=0.01 if opencv else 0.5, extrinsics_noise=0.5,
                 ray_o_grid=1.0, ray_d_grid=1.0)
    cam = dataclasses.replace(cam, **{
        name: torch.from_numpy(rng.normal(size=tuple(getattr(cam, name).shape)).astype(np.float32)
                               * s) for name, s in scale.items()})
    return trainable_camera(cam)


def _trainable(tree):
    for x in named_leaves(tree).values():
        x.requires_grad_(True)
    return tree


def nerf_state(seed=0):
    """A fresh NeRF train state, the same in every process."""
    g = torch.Generator().manual_seed(seed)
    params = {"coarse": _trainable(init_nerf_mlp(NERF_MODEL, generator=g, device="cpu")),
              "fine": _trainable(init_nerf_mlp(NERF_MODEL, generator=g, device="cpu")),
              "camera": _camera(False, seed)}
    cfg = TrainConfig(near=2.0, far=6.0)
    return create_train_state(params, Optimizer.from_config(cfg)), cfg


def nerfpp_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    levels = [_trainable(init_nerfpp_net(PP_MODEL, generator=g, device="cpu")) for _ in range(2)]
    params = {"levels": levels, "camera": _camera(True, seed)}
    cfg = NerfPPTrainConfig()
    return create_train_state(params, Optimizer.from_config(cfg)), cfg


def _matches(rng, opencv):
    """Keypoints of seeded points seen by both images (about a third of a
    pixel of noise), the last one masked off."""
    E = _poses(opencv)
    z = rng.uniform(1.8, 2.6, N_MATCH) * (1 if opencv else -1)
    pts = np.stack([rng.uniform(-0.3, 0.3, N_MATCH), rng.uniform(-0.3, 0.3, N_MATCH), z], -1)

    def project(c2w):
        cam = (np.linalg.inv(c2w) @ np.concatenate([pts, np.ones((N_MATCH, 1))], -1).T).T
        if opencv:
            return np.stack([20.0 * cam[:, 0] / cam[:, 2] + W / 2,
                             20.0 * cam[:, 1] / cam[:, 2] + H / 2], -1) - 0.5
        return np.stack([W / 2 - 20.0 * cam[:, 0] / cam[:, 2],
                         H / 2 + 20.0 * cam[:, 1] / cam[:, 2]], -1)

    mask = np.ones(N_MATCH, bool)
    mask[-1] = False
    return {"kps0": (project(E[0]) + rng.normal(size=(N_MATCH, 2)) * 0.3).astype(np.float32),
            "kps1": (project(E[1]) + rng.normal(size=(N_MATCH, 2)) * 0.3).astype(np.float32),
            "kp_mask": mask, "pair_idx": np.array([0, 1], np.int64)}


def _images(rng):
    y, x = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([np.sin(3 * x + 1), np.cos(2 * y), np.sin(2 * x * y + 0.5)], -1)
    return np.clip(0.5 + 0.4 * base[None] + 0.05 * rng.normal(size=(N_IMAGES, H, W, 3)),
                   0, 1).astype(np.float32)


def _pixels(rng):
    images = _images(rng)
    px, py = rng.integers(0, W, N_RAND), rng.integers(0, H, N_RAND)
    idx = rng.integers(0, N_IMAGES, N_RAND)
    return {"px": px.astype(np.float32), "py": py.astype(np.float32),
            "img_idx": idx.astype(np.int64), "target": images[idx, py, px]}


def nerf_batch(seed):
    """A pixel batch over both images with PRD's matches and every draw."""
    rng = np.random.default_rng(seed)
    s, si = NERF_RENDER.n_samples, NERF_RENDER.n_importance
    batch = _pixels(rng)
    batch["rands"] = {k: rng.random(shape).astype(np.float32) if k in ("t", "u")
                      else rng.normal(size=shape).astype(np.float32)
                      for k, shape in (("t", (N_RAND, s)), ("noise0", (N_RAND, s)),
                                       ("noise1", (N_RAND, s + si)), ("u", (N_RAND, si)))}
    batch.update(_matches(rng, opencv=False))
    return batch


def nerfpp_batch(seed):
    rng = np.random.default_rng(seed)
    batch = _pixels(rng)
    batch["min_depth"] = rng.uniform(1e-4, 0.2, N_RAND).astype(np.float32)
    batch["mask"] = (rng.random(N_RAND) < 0.7).astype(np.float32)
    batch["rands"] = [tuple(rng.random((N_RAND, s)).astype(np.float32) for _ in range(2))
                      for s in PP_RENDER.cascade_samples]
    batch.update(_matches(rng, opencv=True))
    return batch


def padded(batch, multiple=WORLD, replicate=("pair_idx",)):
    """The global batch as the ranks' shards make it up: every array
    ``shard_batch`` shards, edge-padded to a multiple of the world size."""
    if isinstance(batch, dict):
        return {k: (v if k in replicate else padded(v, multiple)) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(padded(v, multiple) for v in batch)
    if isinstance(batch, np.ndarray) and batch.ndim and batch.shape[0] >= multiple:
        return tmesh.pad_to_multiple(batch, multiple)[0]
    return batch


def to_tensors(batch):
    if isinstance(batch, dict):
        return {k: to_tensors(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_tensors(v) for v in batch)
    return torch.as_tensor(batch) if isinstance(batch, np.ndarray) else batch


class Recording:
    """An optimizer that keeps the gradients of each call and passes it on."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = []

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads.append({k: None if g is None else g.detach().clone() for k, g in grads.items()})
        return self.inner.update(grads, state, params)


def nerf_step(cfg, optimizer, group=None):
    return make_train_step(NERF_MODEL, NERF_RENDER, cfg, Curriculum(), optimizer, with_prd=True,
                           group=group)


def nerfpp_step(cfg, optimizer, group=None):
    return make_nerfpp_train_step(PP_MODEL, PP_RENDER, cfg, Curriculum(), optimizer,
                                  with_prd=True, group=group)


def leaves_np(state) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named_leaves(state.params).items()}


def serve_setup():
    from scnerf_tpu_torch.serve import make_nerf_serve_fn

    g = torch.Generator().manual_seed(5)
    params = {"coarse": init_nerf_mlp(NERF_MODEL, generator=g, device="cpu"),
              "fine": init_nerf_mlp(NERF_MODEL, generator=g, device="cpu")}
    fn = make_nerf_serve_fn(params, NERF_MODEL, RenderConfig(n_samples=8, n_importance=8,
                                                             near=2.0, far=6.0))
    rng = np.random.default_rng(6)
    n = 37
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 1.0
    return fn, ((rng.normal(size=(n, 3)) * 0.1).astype(np.float32), rays_d,
                np.full(n, 2.0, np.float32), np.full(n, 6.0, np.float32))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def run_rank(rank: int, world: int, store: str, out: str) -> None:
    """Every scenario on this rank; results into ``out`` (an ``.npz``)."""
    import torch.distributed as dist

    from scnerf_tpu_torch import distributed as tdist
    from scnerf_tpu_torch.kernels import pdf_cuda
    from scnerf_tpu_torch.serve import RenderService
    from scnerf_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    torch.set_num_threads(1)
    res = {}
    topo = tdist.initialize_runtime(f"file://{store}", world, rank, backend="gloo",
                                    timeout_s=GROUP_TIMEOUT_S)
    res["topology"] = np.array([topo["process_index"], topo["process_count"],
                                topo["local_devices"], topo["global_devices"]])
    res["coordinator"] = np.array(tdist.is_coordinator())
    mesh = tdist.make_mesh()

    # replicate_state: rank 1 starts from another state.
    state, cfg = nerf_state(seed=0 if rank == 0 else 1)
    state = tdist.replicate_state(mesh, state)
    res.update({f"replicated/{k}": v for k, v in leaves_np(state).items()})
    res.update({f"replicated_mu/{k}": v.numpy().copy() for k, v in state.opt_state.mu.items()})

    # One NeRF step with PRD on the padded batch.
    rec = Recording(Optimizer.from_config(cfg))
    batch = tdist.shard_batch(mesh, nerf_batch(1), replicate=("pair_idx",), device="cpu")
    res["nerf/rays_per_rank"] = np.array(batch["px"].shape[0])
    state, metrics = nerf_step(cfg, rec, group=dist.group.WORLD)(state, batch)
    res.update({f"nerf/metric/{k}": v.numpy() for k, v in metrics.items()})
    res.update({f"nerf/param/{k}": v for k, v in leaves_np(state).items()})
    res.update({f"nerf/grad/{k}": g.numpy() for k, g in rec.grads[0].items() if g is not None})

    # One NeRF++ step, K2's backward counted.
    calls = []
    backward = pdf_cuda.sample_pdf_diff_backward

    def counting(*args):
        calls.append(1)
        return backward(*args)

    pdf_cuda.sample_pdf_diff_backward = counting
    try:
        pstate, pcfg = nerfpp_state()
        pbatch = tdist.shard_batch(mesh, nerfpp_batch(2), replicate=("pair_idx",), device="cpu")
        pstep = nerfpp_step(pcfg, Optimizer.from_config(pcfg), group=dist.group.WORLD)
        pstate, pmetrics = pstep(pstate, pbatch)
    finally:
        pdf_cuda.sample_pdf_diff_backward = backward
    res["nerfpp/k2_backward_calls"] = np.array(len(calls))
    res.update({f"nerfpp/metric/{k}": v.numpy() for k, v in pmetrics.items()})
    res.update({f"nerfpp/param/{k}": v for k, v in leaves_np(pstate).items()})

    # The grouped service.
    fn, rays = serve_setup()
    grouped = RenderService(fn, 8, device="cpu", group=dist.group.WORLD)(*rays)
    res.update({f"service/{k}": v for k, v in grouped.items()})
    try:
        RenderService(fn, 7, device="cpu", group=dist.group.WORLD)
        res["service_refuses_7"] = np.array(False)
    except ValueError as e:
        res["service_refuses_7"] = np.array("not divisible" in str(e))

    # A 4-step trajectory, uninterrupted and with a rank-0 checkpoint cycle.
    def trajectory(ckpt_dir=None):
        tstate, tcfg = nerf_state()
        step = nerf_step(tcfg, Optimizer.from_config(tcfg), group=dist.group.WORLD)
        losses = []
        for it in range(TRAJECTORY_STEPS):
            if ckpt_dir is not None and it == CKPT_AFTER:
                if tdist.is_coordinator():
                    save_checkpoint(ckpt_dir, tstate)
                dist.barrier()
                tstate = tdist.replicate_state(mesh, restore_checkpoint(ckpt_dir, tstate))
            b = tdist.shard_batch(mesh, nerf_batch(10 + it), replicate=("pair_idx",),
                                  device="cpu")
            tstate, m = step(tstate, b)
            losses.append(float(m["loss"]))
        return np.array(losses), leaves_np(tstate)

    losses, params = trajectory()
    res["traj/losses"] = losses
    res.update({f"traj/param/{k}": v for k, v in params.items()})
    losses, params = trajectory(os.path.join(os.path.dirname(store), "ckpts"))
    res["traj_ckpt/losses"] = losses
    res.update({f"traj_ckpt/param/{k}": v for k, v in params.items()})

    dist.barrier()
    dist.destroy_process_group()
    np.savez(out, **res)


def launch(tmp_path) -> list[dict]:
    """Run both ranks; their results, or a failure with their output."""
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(WORLD), "--store", store, "--out", outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + logs[r][-4000:]
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("dp"))


def single_step(make_state, make_step, batch):
    state, cfg = make_state()
    rec = Recording(Optimizer.from_config(cfg))
    state, metrics = make_step(cfg, rec)(state, to_tensors(padded(batch)))
    return state, metrics, rec.grads[0]


def assert_params_close(got: dict, want: dict, prefix: str):
    keys = [k for k in got if k.startswith(prefix)]
    assert {k[len(prefix):] for k in keys} == set(want)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k[len(prefix):]], atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# Placement against the JAX package
# ---------------------------------------------------------------------------

class TestPlacementAgainstJax:
    @pytest.fixture(scope="class")
    def jmesh(self):
        jax = pytest.importorskip("jax")
        from scnerf_tpu.distributed import mesh as jm

        if len(jax.devices()) < WORLD:
            pytest.skip("needs two forced host devices")
        return jm, jm.make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])

    def test_make_mesh(self, jmesh):
        jm, jax_mesh = jmesh
        mesh = tmesh.make_mesh()  # this process alone
        assert mesh.shape == {tmesh.DATA_AXIS: 1, tmesh.MODEL_AXIS: 1}
        assert mesh.axis_names == jax_mesh.axis_names == (jm.DATA_AXIS, jm.MODEL_AXIS)
        assert dict(jax_mesh.shape) == tmesh.Mesh(n_data=WORLD).shape
        with pytest.raises(ValueError, match="tensor-parallel"):
            tmesh.make_mesh(n_model=2)
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_mesh(n_data=2)

    @pytest.mark.parametrize("n,multiple,axis", [(10, 8, 0), (16, 8, 0), (5, 3, 1), (1, 2, 0)])
    def test_pad_to_multiple(self, jmesh, n, multiple, axis):
        jm, _ = jmesh
        shape = [4, 4]
        shape[axis] = n
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        got, got_n = tmesh.pad_to_multiple(x, multiple, axis)
        want, want_n = jm.pad_to_multiple(x, multiple, axis)
        np.testing.assert_array_equal(got, want)
        assert got_n == want_n == n

    def test_shard_batch(self, jmesh):
        from jax.sharding import PartitionSpec

        jm, jax_mesh = jmesh
        rng = np.random.default_rng(0)
        batch = {"px": np.arange(1001, dtype=np.float32),
                 "target": rng.random((1001, 3)).astype(np.float32),
                 "kps0": rng.random((7, 2)).astype(np.float32),
                 "pair_idx": np.array([0, 1]),
                 "one": np.array([3.0], np.float32),
                 "scalar": np.array(2.5, np.float32)}
        want = jm.shard_batch(jax_mesh, batch)
        for rank in range(WORLD):
            got = tmesh.shard_batch(tmesh.Mesh(n_data=WORLD, rank=rank), batch, device="cpu")
            for k, v in want.items():
                sharded = v.sharding.spec == PartitionSpec(jm.DATA_AXIS)
                shard = next(s for s in v.addressable_shards
                             if s.device == jax_mesh.devices[rank, 0])
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data), err_msg=k)
                assert (got[k].shape[:1] != v.shape[:1]) == sharded, k
        assert got["px"].shape == (501,)  # 1001 padded to 1002, half each
        kept = tmesh.shard_batch(tmesh.Mesh(n_data=WORLD, rank=1), batch, replicate=("pair_idx",),
                                 device="cpu")
        np.testing.assert_array_equal(kept["pair_idx"].numpy(), [0, 1])

    def test_shard_batch_refuses_without_padding(self, jmesh):
        jm, jax_mesh = jmesh
        batch = {"px": np.arange(1001, dtype=np.float32)}
        with pytest.raises(ValueError, match="not divisible"):
            jm.shard_batch(jax_mesh, batch, pad=False)
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.shard_batch(tmesh.Mesh(n_data=WORLD), batch, pad=False, device="cpu")


# ---------------------------------------------------------------------------
# Two gloo ranks against one process
# ---------------------------------------------------------------------------

class TestDataParallel:
    def test_runtime_topology(self, ranks):
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["topology"], [r, WORLD, 1, WORLD])
            assert bool(res["coordinator"]) == (r == 0)

    def test_replicate_state_takes_rank0s(self, ranks):
        state, _ = nerf_state(seed=0)
        want = leaves_np(state)
        for res in ranks:
            assert_params_close(res, want, "replicated/")
            for k in state.opt_state.mu:
                np.testing.assert_array_equal(res[f"replicated_mu/{k}"], 0.0)

    def test_nerf_step_with_prd_and_padding(self, ranks):
        state, metrics, _ = single_step(nerf_state, nerf_step, nerf_batch(1))
        assert int(ranks[0]["nerf/rays_per_rank"]) == (N_RAND + 1) // WORLD
        assert float(metrics["prd_matches"]) > 0
        for res in ranks:
            for k, v in metrics.items():
                np.testing.assert_allclose(res[f"nerf/metric/{k}"], v.numpy(), rtol=RTOL,
                                           err_msg=k)
            assert_params_close(res, leaves_np(state), "nerf/param/")

    def test_gradients_bit_equal_across_ranks(self, ranks):
        keys = [k for k in ranks[0] if k.startswith("nerf/grad/")]
        assert any(k.startswith("nerf/grad/camera/") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
            assert np.any(ranks[0][k] != 0), k
        for k in (k for k in ranks[0] if k.startswith("nerf/param/")):
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)

    def test_nerfpp_step_with_k2_backward(self, ranks):
        state, metrics, _ = single_step(nerfpp_state, nerfpp_step, nerfpp_batch(2))
        for res in ranks:
            assert int(res["nerfpp/k2_backward_calls"]) == 1
            for k, v in metrics.items():
                np.testing.assert_allclose(res[f"nerfpp/metric/{k}"], v.numpy(), rtol=RTOL,
                                           err_msg=k)
            assert_params_close(res, leaves_np(state), "nerfpp/param/")

    def test_grouped_service(self, ranks):
        from scnerf_tpu_torch.serve import RenderService

        fn, rays = serve_setup()
        want = RenderService(fn, 8, device="cpu")(*rays)
        for res in ranks:
            for k, v in want.items():
                np.testing.assert_array_equal(res[f"service/{k}"], v, err_msg=k)
            assert bool(res["service_refuses_7"])  # a batch the ranks do not divide

    def test_trajectory_with_rank0_checkpoint(self, ranks):
        state, cfg = nerf_state()
        step = nerf_step(cfg, Optimizer.from_config(cfg))
        losses = []
        for it in range(TRAJECTORY_STEPS):
            state, m = step(state, to_tensors(padded(nerf_batch(10 + it))))
            losses.append(float(m["loss"]))
        for res in ranks:
            np.testing.assert_array_equal(res["traj_ckpt/losses"], res["traj/losses"])
            for k in (k for k in res if k.startswith("traj/param/")):
                np.testing.assert_array_equal(res["traj_ckpt/" + k[5:]], res[k], err_msg=k)
            np.testing.assert_allclose(res["traj/losses"], losses, rtol=RTOL)
            assert_params_close(res, leaves_np(state), "traj/param/")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--out", required=True)
    a = parser.parse_args()
    run_rank(a.rank, a.world, a.store, a.out)
