"""The port's curriculum and optimizer chain against the JAX package.

- The curriculum's camera masks, ``prd_active`` (with and without the PRD
  anneal) and ``prd_cadence_at``, step by step.
- The optimizer (``train/optim.py:Optimizer``) against ``make_optimizer``'s
  optax chain over 5 steps fed the same seeded gradients, one inf and one
  1e7 entry among them for the clip, with every option on: per-leaf updates
  within relative 1e-6 (L2). The frozen leaves never move; a locked grid
  with weight decay moves as in JAX; ``hold != 1`` with ``until == 0``
  raises (the JAX chain drops that hold).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.camera.model import CameraConfig as JCameraConfig  # noqa: E402
from scnerf_tpu.camera.model import init_camera as j_init_camera  # noqa: E402
from scnerf_tpu.fields.nerf import NeRFConfig as JNeRFConfig  # noqa: E402
from scnerf_tpu.fields.nerf import init_nerf_mlp as j_init_nerf_mlp  # noqa: E402
from scnerf_tpu.train import curriculum as jcur  # noqa: E402
from scnerf_tpu.train import optim as joptim  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import FROZEN_LEAVES, TRAINABLE_LEAVES  # noqa: E402
from scnerf_tpu_torch.train import curriculum as tcur  # noqa: E402
from scnerf_tpu_torch.train import optim as toptim  # noqa: E402

SMALL = JNeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
CURRICULA = [
    jcur.Curriculum(),
    jcur.Curriculum(add_ie=2, add_od=5, add_radial=3, add_prd=4),
    jcur.Curriculum(add_prd=1, ray_dist_loss_weight=1e-3, i_ray_dist_loss=1,
                    prd_anneal_until=5, ray_dist_loss_weight_after=1e-4,
                    i_ray_dist_loss_after=10),
]
# Every option of the chain on; the floor bites from the third step.
CHAIN = dict(lr_init=1e-2, decay_steps=2.0, decay_factor=0.1, weight_decay=0.1,
             lr_floor=3e-3, camera_lr_mult=4.0, camera_lr_mult_until=3,
             camera_lr_mult_hold=0.5, distortion_lr_mult=2.0)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_params(seed=0):
    """A small NeRF pair and a camera with every learnable leaf non-zero."""
    rng = np.random.default_rng(seed)
    cam = j_init_camera(np.array([[20.0, 0, 8, 0], [0, 21.0, 8, 0], [0, 0, 1, 0], [0, 0, 0, 1]]),
                        np.tile(np.eye(4), (2, 1, 1)), JCameraConfig(H=16, W=16, grid_size=4),
                        k=np.array([0.02, -0.01]))
    cam = cam.replace(**{name: jnp.asarray(rng.normal(size=getattr(cam, name).shape) * 0.1,
                                           jnp.float32)
                         for name in TRAINABLE_LEAVES})
    k = jax.random.key(seed)
    return {"coarse": j_init_nerf_mlp(k, SMALL), "fine": j_init_nerf_mlp(jax.random.fold_in(k, 1),
                                                                           SMALL),
            "camera": cam}


def _jax_leaves(tree):
    """A JAX train tree's leaves by the port's paths."""
    out = toptim.named_leaves({k: v for k, v in tree.items() if k != "camera"})
    out.update({f"camera/{name}": getattr(tree["camera"], name)
                for name in (*FROZEN_LEAVES, *TRAINABLE_LEAVES)})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_tree_like(params, by_path, prefix=""):
    """``params``' structure with the leaves of ``by_path``."""
    if isinstance(params, dict):
        return {k: (v.replace(**{name: jnp.asarray(by_path[f"camera/{name}"])
                                 for name in (*FROZEN_LEAVES, *TRAINABLE_LEAVES)})
                    if k == "camera" else _jax_tree_like(v, by_path, f"{prefix}{k}/"))
                for k, v in params.items()}
    if isinstance(params, list):
        return [_jax_tree_like(v, by_path, f"{prefix}{i}/") for i, v in enumerate(params)]
    return jnp.asarray(by_path[prefix[:-1]])


def _gradients(leaves, rng, clip=True):
    """Seeded gradients for every leaf; with ``clip``, one inf and one 1e7
    entry for the clip to bound."""
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in leaves.items()}
    if clip:
        grads["coarse/pts/0/w"][0, 0] = np.inf
        grads["camera/ray_o_grid"][0, 0, 0] = 1e7
    return grads


class TestCurriculum:
    @pytest.mark.parametrize("cur", CURRICULA, ids=["default", "thresholds", "anneal"])
    def test_masks_weight_and_cadence(self, cur):
        port = bridge.convert_config(cur, tcur.Curriculum)
        rng = np.random.default_rng(1)
        cam = _jax_params()["camera"]
        grads = cam.replace(**{name: jnp.asarray(rng.normal(size=getattr(cam, name).shape),
                                                 jnp.float32)
                               for name in (*FROZEN_LEAVES, *TRAINABLE_LEAVES)})
        for step in range(8):
            want = jcur.mask_camera_grads(grads, jnp.asarray(step), cur)
            got = tcur.mask_camera_grads(
                {name: torch.from_numpy(np.array(getattr(grads, name)))
                 for name in TRAINABLE_LEAVES}, step, port)
            for name in TRAINABLE_LEAVES:
                np.testing.assert_array_equal(got[name].numpy(), np.asarray(getattr(want, name)))
            assert tcur.prd_active(step, port) == pytest.approx(
                float(jcur.prd_active(jnp.asarray(step), cur)), rel=1e-6)
            assert tcur.prd_cadence_at(step, port) == jcur.prd_cadence_at(step, cur)

    def test_masking_multiplies(self):
        """Masking multiplies by zero, as in JAX: a NaN stays NaN."""
        got = tcur.mask_camera_grads({"ray_o_grid": torch.tensor([np.nan, 1.0])}, 0,
                                     tcur.Curriculum(add_od=3))
        assert torch.isnan(got["ray_o_grid"][0]) and got["ray_o_grid"][1] == 0.0


class TestOptimizer:
    @pytest.mark.parametrize("chain", [
        CHAIN,
        dict(lr_init=5e-4, decay_steps=250e3, weight_decay=0.1),
        dict(lr_init=1e-3, decay_steps=10.0, grad_clip=0.0, distortion_lr_mult=3.0,
             distortion_lr_mult_until=2, distortion_lr_mult_hold=0.25),
    ], ids=["every_option", "bench", "distortion_anneal"])
    def test_updates_match_optax(self, chain):
        jp = _jax_params()
        tx = joptim.make_optimizer(params_example=jp, **chain)
        opt_state = tx.init(jp)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        opt = toptim.Optimizer(**chain)
        state = opt.init(tp)
        leaves = toptim.trainable_leaves(tp)
        assert set(state.mu) == set(leaves)
        rng = np.random.default_rng(2)
        for step in range(5):
            grads = _gradients(_jax_leaves(jp), rng, clip=chain.get("grad_clip", 1e6) > 0)
            updates, opt_state = tx.update(_jax_tree_like(jp, grads), opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            want = _jax_leaves(updates)
            got = opt.update({k: torch.from_numpy(grads[k]) for k in leaves}, state, leaves)
            toptim.apply_updates(leaves, got)
            assert state.count == step + 1
            for path, u in got.items():
                assert np.isfinite(u.numpy()).all(), path
                assert _rel_l2(u.numpy(), want[path]) <= 1e-6, (step, path)
            for path in FROZEN_LEAVES:
                assert not np.abs(want[f"camera/{path}"]).any()
        for path, x in _jax_leaves(jp).items():
            got = toptim.named_leaves(tp)[path].detach().numpy()
            np.testing.assert_allclose(got, x, rtol=1e-6, atol=1e-7, err_msg=path)

    def test_frozen_leaves_never_move(self):
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, _jax_params()), device="cpu")
        before = {name: getattr(tp["camera"], name).clone() for name in FROZEN_LEAVES}
        opt = toptim.Optimizer(**CHAIN)
        state = opt.init(tp)
        assert not any(path.endswith(FROZEN_LEAVES) for path in state.mu)
        leaves = toptim.trainable_leaves(tp)
        rng = np.random.default_rng(3)
        for _ in range(3):
            grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                     for k, v in leaves.items()}
            toptim.apply_updates(leaves, opt.update(grads, state, leaves))
        for name, x in before.items():
            assert not getattr(tp["camera"], name).requires_grad
            assert torch.equal(getattr(tp["camera"], name), x)

    def test_missing_gradient_counts_as_zero(self):
        """A leaf without a gradient (the OpenGL camera's distortion noise)
        still takes its step: weight decay moves it, and its bias
        corrections keep pace with the other leaves'."""
        jp = _jax_params()
        tx = joptim.make_optimizer(params_example=jp, **CHAIN)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        opt = toptim.Optimizer(**CHAIN)
        state, opt_state = opt.init(tp), tx.init(jp)
        leaves = toptim.trainable_leaves(tp)
        rng = np.random.default_rng(4)
        for _ in range(3):
            grads = _gradients(_jax_leaves(jp), rng)
            grads["camera/distortion_noise"][:] = 0.0
            updates, opt_state = tx.update(_jax_tree_like(jp, grads), opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            port_grads = {k: torch.from_numpy(grads[k]) for k in leaves}
            port_grads["camera/distortion_noise"] = None
            got = opt.update(port_grads, state, leaves)
            toptim.apply_updates(leaves, got)
            want = _jax_leaves(updates)["camera/distortion_noise"]
            assert np.abs(want).min() > 0.0
            assert _rel_l2(got["camera/distortion_noise"].numpy(), want) <= 1e-6

    def test_locked_grid_decays_as_in_jax(self):
        """Curriculum-locked leaves get a zero gradient, not exclusion: with
        weight decay a locked, non-zero grid still moves."""
        cur = jcur.Curriculum(add_ie=2, add_od=5)
        port_cur = bridge.convert_config(cur, tcur.Curriculum)
        jp = _jax_params()
        chain = dict(lr_init=1e-3, decay_steps=100.0, weight_decay=0.1)
        tx = joptim.make_optimizer(params_example=jp, **chain)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        opt = toptim.Optimizer(**chain)
        state, opt_state = opt.init(tp), tx.init(jp)
        leaves = toptim.trainable_leaves(tp)
        grads = _gradients(_jax_leaves(jp), np.random.default_rng(5))
        jgrads = _jax_tree_like(jp, grads)
        jgrads["camera"] = jcur.mask_camera_grads(jgrads["camera"], jnp.asarray(0), cur)
        updates, _ = tx.update(jgrads, opt_state, jp)
        want = _jax_leaves(updates)
        cam = tcur.mask_camera_grads(
            {toptim.leaf_name(k): torch.from_numpy(grads[k]) for k in leaves
             if k.startswith("camera/")}, 0, port_cur)
        port_grads = {k: torch.from_numpy(grads[k]) for k in leaves}
        port_grads.update({f"camera/{name}": g for name, g in cam.items()})
        got = opt.update(port_grads, state, leaves)
        for name in ("ray_o_grid", "ray_d_grid"):
            assert np.abs(want[f"camera/{name}"]).min() > 0.0  # decay moves it
            assert _rel_l2(got[f"camera/{name}"].numpy(), want[f"camera/{name}"]) <= 1e-6
        for name in ("intrinsics_noise", "extrinsics_noise"):  # locked, no decay
            assert not np.abs(want[f"camera/{name}"]).any()
            assert not got[f"camera/{name}"].abs().any()

    @pytest.mark.parametrize("group", ["camera", "distortion"])
    def test_hold_without_until_raises(self, group):
        with pytest.raises(ValueError, match="until"):
            toptim.Optimizer(lr_init=1e-3, decay_steps=10.0, **{f"{group}_lr_mult_hold": 0.5})
        toptim.Optimizer(lr_init=1e-3, decay_steps=10.0, **{f"{group}_lr_mult_hold": 0.5,
                                                            f"{group}_lr_mult_until": 3})

    def test_from_config_reads_the_train_config(self):
        """The schedule and the L2 decay come from the train config alone,
        as the JAX drivers build ``make_optimizer`` from theirs."""
        from scnerf_tpu.train.step import TrainConfig as JTrainConfig
        from scnerf_tpu_torch.train.step import TrainConfig

        cfg = bridge.convert_config(JTrainConfig(lr_init=2e-3, lr_decay_steps=500.0,
                                                 lr_decay_factor=0.5, weight_decay=0.1),
                                    TrainConfig)
        opt = toptim.Optimizer.from_config(cfg, camera_lr_mult=4.0)
        assert (opt.lr_init, opt.decay_steps, opt.decay_factor, opt.weight_decay,
                opt.camera_lr_mult) == (2e-3, 500.0, 0.5, 0.1, 4.0)
        assert opt.learning_rate(500) == pytest.approx(1e-3, rel=1e-6)

    def test_named_leaves(self):
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, _jax_params()), device="cpu")
        paths = list(toptim.named_leaves(tp))
        assert "coarse/pts/0/w" in paths and "fine/rgb/b" in paths
        assert [p for p in paths if p.startswith("camera/")] == [
            f"camera/{name}" for name in (*FROZEN_LEAVES, *TRAINABLE_LEAVES)]
        assert set(toptim.trainable_leaves(tp)) == {
            p for p in paths if toptim.leaf_name(p) not in FROZEN_LEAVES}
