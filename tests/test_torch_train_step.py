"""The port's NeRF train step against the JAX package's, at a small size:
NeRF depth 3, width 32, skip at 1, multires 4/2, 8+8 samples, a 16x16
OpenGL camera with 4-px noise grids over two images, ``perturb=True`` and
``raw_noise_std=1.0``, every random draw injected (``t``, ``noise0``,
``noise1``, ``u``) so both sides see the same numbers. With ``u`` injected
the JAX step takes its XLA sampler (no Pallas kernel is reached) and the
port's K1 wrapper its plain twin.

- One step, five cases (pixel batch with the full camera, given rays
  without a camera, NDC with the learned focal, PRD, a locked curriculum):
  loss and metrics within relative 1e-5, ``prd_matches`` equal, and per
  leaf a relative L2 error <= 1e-4 and a cosine >= 0.9999. The JAX side's
  gradients are the raw masked gradients its step hands to the optimizer:
  its transformation keeps them in its state. (``optax.sgd(1.0)``'s delta
  ``p - (p - g)`` loses the low bits of ``g`` where ``|g| << |p|``, as on
  the noise grids, by far more than 1e-4.)
- One full step with ``make_optimizer`` on both sides: the parameters after
  it, relative 1e-5, on the entries whose gradient is not near zero (there
  Adam's first step is about ``lr * sign(g)``, so a gradient near zero may
  flip its step).
- A 100-step trajectory with the same injected randoms each step: every
  step's loss within 1% and the final PSNR within 0.1 dB.
- ``sample_batch_on_device`` and ``make_device_sampling_step``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import GradientCapture, assert_gradients_close  # noqa: E402
from _torch_support import gradient_tx as _gradient_tx  # noqa: E402
from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import to_jax as _to_jax  # noqa: E402
from _torch_support import to_port as _to_port  # noqa: E402
from scnerf_tpu.camera.model import CameraConfig as JCameraConfig  # noqa: E402
from scnerf_tpu.camera.model import init_camera as j_init_camera  # noqa: E402
from scnerf_tpu.fields.nerf import NeRFConfig as JNeRFConfig  # noqa: E402
from scnerf_tpu.fields.nerf import init_nerf_mlp as j_init_nerf_mlp  # noqa: E402
from scnerf_tpu.render.renderer import RenderConfig as JRenderConfig  # noqa: E402
from scnerf_tpu.train import curriculum as jcur  # noqa: E402
from scnerf_tpu.train import optim as joptim  # noqa: E402
from scnerf_tpu.train import step as jstep  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.camera.model import FROZEN_LEAVES, TRAINABLE_LEAVES  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig  # noqa: E402
from scnerf_tpu_torch.render import renderer as trend  # noqa: E402
from scnerf_tpu_torch.train import curriculum as tcur  # noqa: E402
from scnerf_tpu_torch.train import device_sampling  # noqa: E402
from scnerf_tpu_torch.train import optim as toptim  # noqa: E402
from scnerf_tpu_torch.train import step as tstep  # noqa: E402

J_MODEL = JNeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
J_RENDER = JRenderConfig(n_samples=8, n_importance=8, perturb=True, raw_noise_std=1.0,
                         remat_chunk=0)
T_MODEL = bridge.convert_config(J_MODEL, NeRFConfig)
T_RENDER = bridge.convert_config(J_RENDER, trend.RenderConfig)
H = W = 16
FOCAL = 20.0
N_IMAGES = 2
N_RAND = 64
N_MATCH = 8
METRIC_RTOL = 1e-5


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _poses():
    E = np.tile(np.eye(4), (N_IMAGES, 1, 1))
    E[1, :3, :3] = _rotation([0.1, 1.0, 0.0], 0.25)
    E[1, :3, 3] = [1.0, 0.0, 0.1]
    return E


K = np.array([[FOCAL, 0, W / 2, 0], [0, FOCAL, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def jax_params(seed=0, camera=True):
    """A small NeRF pair and, with ``camera``, the learnable camera with
    every learnable leaf non-zero (the OpenGL camera's distortion noise
    too; it reads none of it)."""
    rng = np.random.default_rng(seed)
    k = jax.random.key(seed)
    params = {"coarse": j_init_nerf_mlp(k, J_MODEL),
              "fine": j_init_nerf_mlp(jax.random.fold_in(k, 1), J_MODEL)}
    if camera:
        cam = j_init_camera(K, _poses(), JCameraConfig(H=H, W=W, grid_size=4))
        scale = dict(intrinsics_noise=0.5, extrinsics_noise=0.5, distortion_noise=1.0,
                     ray_o_grid=1.0, ray_d_grid=1.0)
        params["camera"] = cam.replace(**{
            name: jnp.asarray(rng.normal(size=getattr(cam, name).shape) * s, jnp.float32)
            for name, s in scale.items()})
    return params


def rands(rng, n=N_RAND):
    s, si = J_RENDER.n_samples, J_RENDER.n_importance
    return {"t": rng.random((n, s)), "noise0": rng.normal(size=(n, s)),
            "noise1": rng.normal(size=(n, s + si)), "u": rng.random((n, si))}


def _image(rng):
    """Smooth synthetic images ``(N_IMAGES, H, W, 3)`` in [0, 1]."""
    y, x = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([np.sin(3 * x + 1), np.cos(2 * y), np.sin(2 * x * y + 0.5)], -1)
    return np.clip(0.5 + 0.4 * base[None] + 0.05 * rng.normal(size=(N_IMAGES, H, W, 3)), 0, 1)


def pixel_batch(rng, images=None):
    images = _image(rng) if images is None else images
    px = rng.integers(0, W, N_RAND)
    py = rng.integers(0, H, N_RAND)
    idx = rng.integers(0, N_IMAGES, N_RAND)
    return {"px": px.astype(np.float32), "py": py.astype(np.float32),
            "img_idx": idx.astype(np.int32), "target": images[idx, py, px],
            "rands": rands(rng)}


def ray_batch(rng):
    rays_d = rng.normal(size=(N_RAND, 3))
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 1.0
    return {"rays_o": rng.normal(size=(N_RAND, 3)) * 0.1, "rays_d": rays_d,
            "target": rng.random((N_RAND, 3)), "rands": rands(rng)}


def prd_batch(rng):
    """A pixel batch plus N_MATCH correspondences between the two images,
    projections of points in front of both (about half a pixel of noise),
    the last one padded."""
    batch = pixel_batch(rng)
    E = _poses()
    pts = np.stack([rng.uniform(0.0, 1.0, N_MATCH), rng.uniform(-0.5, 0.5, N_MATCH),
                    -rng.uniform(2.5, 3.5, N_MATCH)], -1)

    def project(c2w):
        cam = (np.linalg.inv(c2w) @ np.concatenate([pts, np.ones((N_MATCH, 1))], -1).T).T
        return np.stack([W / 2 - FOCAL * cam[:, 0] / cam[:, 2],
                         H / 2 + FOCAL * cam[:, 1] / cam[:, 2]], -1)

    batch["kps0"] = project(E[0]) + rng.normal(size=(N_MATCH, 2)) * 0.5
    batch["kps1"] = project(E[1]) + rng.normal(size=(N_MATCH, 2)) * 0.5
    mask = np.ones(N_MATCH, bool)
    mask[-1] = False
    batch["kp_mask"] = mask
    batch["pair_idx"] = np.array([0, 1], np.int32)
    return batch


def jax_leaves(tree):
    """A JAX train tree's trainable leaves by the port's paths, as numpy."""
    out = toptim.named_leaves({k: v for k, v in tree.items() if k != "camera"})
    if tree.get("camera") is not None:
        out.update({f"camera/{name}": getattr(tree["camera"], name) for name in TRAINABLE_LEAVES})
    return {k: np.asarray(v) for k, v in out.items()}


def run_jax_step(jp, batch, train_cfg, cur, tx, with_prd=False, step=0):
    state = jstep.create_train_state(jp, tx)
    state = state.replace(step=jnp.asarray(step, jnp.int32))
    fn = jstep.make_train_step(J_MODEL, J_RENDER, train_cfg, cur, tx, with_prd=with_prd,
                               donate=False)
    return jax.block_until_ready(fn(state, _to_jax(batch), jax.random.key(0)))


def run_port_step(jp, batch, train_cfg, cur, optimizer, with_prd=False, step=0):
    tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    state = tstep.create_train_state(tp, optimizer)
    state.step = step
    fn = tstep.make_train_step(T_MODEL, T_RENDER, bridge.convert_config(train_cfg, tstep.TrainConfig),
                               bridge.convert_config(cur, tcur.Curriculum), optimizer,
                               with_prd=with_prd)
    return fn(state, _to_port(batch))


def one_step_gradients(jp, batch, train_cfg, cur, with_prd=False, step=0):
    j_state, j_metrics = run_jax_step(jp, batch, train_cfg, cur, _gradient_tx(), with_prd, step)
    capture = GradientCapture()
    _, t_metrics = run_port_step(jp, batch, train_cfg, cur, capture, with_prd, step)
    return j_metrics, jax_leaves(j_state.opt_state), t_metrics, capture.grads


def assert_metrics_close(t_metrics, j_metrics):
    assert set(t_metrics) == set(j_metrics)
    for k, v in t_metrics.items():
        if k == "prd_matches":
            assert float(v) == float(j_metrics[k])
        else:
            np.testing.assert_allclose(float(v), float(j_metrics[k]), rtol=METRIC_RTOL,
                                       err_msg=k)


STEP_CASES = {
    "pixels_full_camera": dict(),
    "rays_no_camera": dict(camera=False),
    "ndc": dict(train_cfg=jstep.TrainConfig(use_ndc=True, near=0.0, far=1.0)),
    "prd": dict(with_prd=True, cur=jcur.Curriculum(ray_dist_loss_weight=0.1)),
    "locked_camera": dict(cur=jcur.Curriculum(add_ie=2, add_od=5)),
}


class TestOneStep:
    @pytest.mark.parametrize("case", list(STEP_CASES))
    def test_gradients_match_jax(self, case):
        spec = STEP_CASES[case]
        rng = np.random.default_rng(10)
        camera = spec.get("camera", True)
        jp = jax_params(camera=camera)
        batch = (prd_batch(rng) if spec.get("with_prd") else
                 pixel_batch(rng) if camera else ray_batch(rng))
        train_cfg = spec.get("train_cfg", jstep.TrainConfig(near=2.0, far=6.0))
        cur = spec.get("cur", jcur.Curriculum())
        j_metrics, j_grads, t_metrics, t_grads = one_step_gradients(
            jp, batch, train_cfg, cur, with_prd=spec.get("with_prd", False))
        assert_metrics_close(t_metrics, j_metrics)
        assert_gradients_close(t_grads, j_grads)
        if camera:
            # OpenGL reads no distortion: no gradient at all in the port.
            assert t_grads["camera/distortion_noise"] is None
            assert not j_grads["camera/distortion_noise"].any()
        if case == "pixels_full_camera":
            # Both the rotation and the translation part of the extrinsics
            # noise get their gradient (the decoder writes the translation
            # into the rotation's 4x4 buffer in place).
            ext = t_grads["camera/extrinsics_noise"].numpy()
            assert np.abs(ext[:, :6]).min() > 0 and np.abs(ext[:, 6:]).min() > 0
        if case == "prd":
            assert float(t_metrics["prd_matches"]) >= 4
            assert float(t_metrics["prd"]) > 0
        if case == "locked_camera":
            for name in ("intrinsics_noise", "extrinsics_noise", "ray_o_grid", "ray_d_grid"):
                assert not t_grads[f"camera/{name}"].abs().any(), name
                assert not np.abs(j_grads[f"camera/{name}"]).any(), name

    def test_prd_pair_without_matches_adds_nothing(self):
        """Every match padded: ``prd`` 0 and no PRD gradient (the NaN
        skip), the same gradients as without PRD."""
        rng = np.random.default_rng(11)
        batch = prd_batch(rng)
        batch["kp_mask"][:] = False
        train_cfg = jstep.TrainConfig(near=2.0, far=6.0)
        cur = jcur.Curriculum(ray_dist_loss_weight=0.1)
        jp = jax_params()
        j_metrics, j_grads, t_metrics, t_grads = one_step_gradients(
            jp, batch, train_cfg, cur, with_prd=True)
        assert float(t_metrics["prd"]) == float(j_metrics["prd"]) == 0.0
        assert float(t_metrics["prd_matches"]) == 0.0
        assert_gradients_close(t_grads, j_grads)
        plain = dict(batch)
        for k in ("kps0", "kps1", "kp_mask", "pair_idx"):
            del plain[k]
        _, _, _, t_plain = one_step_gradients(jp, plain, train_cfg, cur)
        for path, g in t_plain.items():
            if g is not None:
                torch.testing.assert_close(t_grads[path], g, rtol=1e-6, atol=0)

    def test_runs_in_float32_and_restores_the_flags(self, monkeypatch):
        seen = []
        query_field = trend.query_field

        def recording(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return query_field(*args, **kwargs)

        monkeypatch.setattr(trend, "query_field", recording)
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            run_port_step(jax_params(), pixel_batch(np.random.default_rng(12)),
                          jstep.TrainConfig(near=2.0, far=6.0), jcur.Curriculum(),
                          GradientCapture())
            assert seen and not any(any(flags) for flags in seen)
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def jax_optimizer(train_cfg, jp):
    """``make_optimizer`` from a train config, as the JAX drivers build it."""
    return joptim.make_optimizer(train_cfg.lr_init, train_cfg.lr_decay_steps,
                                 decay_factor=train_cfg.lr_decay_factor,
                                 weight_decay=train_cfg.weight_decay, params_example=jp)


def port_optimizer(train_cfg):
    return toptim.Optimizer.from_config(bridge.convert_config(train_cfg, tstep.TrainConfig))


class TestFullStep:
    @pytest.mark.parametrize("with_prd", [False, True])
    def test_params_after_one_step_match_jax(self, with_prd):
        rng = np.random.default_rng(13)
        jp = jax_params()
        batch = prd_batch(rng) if with_prd else pixel_batch(rng)
        train_cfg = jstep.TrainConfig(near=2.0, far=6.0, weight_decay=0.1)
        cur = jcur.Curriculum(ray_dist_loss_weight=0.1)
        _, j_grads, _, _ = one_step_gradients(jp, batch, train_cfg, cur, with_prd=with_prd)
        j_state, j_metrics = run_jax_step(jp, batch, train_cfg, cur, jax_optimizer(train_cfg, jp),
                                          with_prd)
        t_state, t_metrics = run_port_step(jp, batch, train_cfg, cur, port_optimizer(train_cfg),
                                           with_prd)
        assert t_state.step == 1 and t_state.opt_state.count == 1
        assert_metrics_close(t_metrics, j_metrics)
        want = jax_leaves(j_state.params)
        got = toptim.named_leaves(t_state.params)
        for path, g in j_grads.items():
            settled = np.abs(g) > 1e-4 * np.abs(g).max() if np.abs(g).any() else np.ones_like(g, bool)
            p = got[path].detach().numpy()
            np.testing.assert_allclose(p[settled], want[path][settled], rtol=1e-5, atol=0,
                                       err_msg=path)
            # Elsewhere at most a flipped step apart.
            assert np.abs(p - want[path]).max() <= 2 * 5e-4 * 1.001, path
        for name in FROZEN_LEAVES:
            np.testing.assert_array_equal(getattr(t_state.params["camera"], name).numpy(),
                                          np.asarray(getattr(jp["camera"], name)))


class TestTrajectory:
    def test_100_steps_track_jax(self):
        """The same batches and randoms on both sides each step, the full
        camera, make_optimizer's chain: every loss within 1%, final PSNR
        within 0.1 dB, and the loss comes down."""
        rng = np.random.default_rng(14)
        images = _image(rng)
        batches = [pixel_batch(rng, images) for _ in range(100)]
        train_cfg = jstep.TrainConfig(lr_init=2e-3, lr_decay_steps=500.0, weight_decay=0.1,
                                      near=2.0, far=6.0)
        cur = jcur.Curriculum()
        jp = jax_params()
        tx = jax_optimizer(train_cfg, jp)
        j_state = jstep.create_train_state(jp, tx)
        j_fn = jstep.make_train_step(J_MODEL, J_RENDER, train_cfg, cur, tx, donate=False)
        tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        optimizer = port_optimizer(train_cfg)
        t_state = tstep.create_train_state(tp, optimizer)
        t_fn = tstep.make_train_step(T_MODEL, T_RENDER,
                                     bridge.convert_config(train_cfg, tstep.TrainConfig),
                                     bridge.convert_config(cur, tcur.Curriculum), optimizer)
        j_loss, t_loss = [], []
        key = jax.random.key(0)
        for batch in batches:
            j_state, jm = jax.block_until_ready(j_fn(j_state, _to_jax(batch), key))
            t_state, tm = t_fn(t_state, _to_port(batch))
            j_loss.append(float(jm["loss"]))
            t_loss.append(float(tm["loss"]))
        j_loss, t_loss = np.array(j_loss), np.array(t_loss)
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-2)
        assert abs(float(tm["psnr"]) - float(jm["psnr"])) < 0.1
        assert t_loss[-10:].mean() < t_loss[:10].mean()
        assert t_state.step == 100


class TestDeviceSampling:
    def _images(self):
        return torch.from_numpy(np.random.default_rng(15).random((3, 20, 24, 3)).astype(np.float32))

    @pytest.mark.parametrize("single_image", [True, False])
    @pytest.mark.parametrize("precrop_frac", [None, 0.5])
    def test_batch(self, single_image, precrop_frac):
        images = self._images()
        gen = torch.Generator().manual_seed(0)
        batch = device_sampling.sample_batch_on_device(
            images, gen, 500, precrop_frac=precrop_frac, single_image=single_image)
        px, py, idx = batch["px"], batch["py"], batch["img_idx"]
        assert px.shape == py.shape == idx.shape == (500,)
        assert px.dtype == py.dtype == torch.float32 and idx.dtype == torch.int64
        assert batch["target"].shape == (500, 3) and batch["target"].dtype == torch.float32
        lo_x, hi_x, lo_y, hi_y = (0, 24, 0, 20) if precrop_frac is None else (6, 18, 5, 15)
        assert int(px.min()) >= lo_x and int(px.max()) < hi_x
        assert int(py.min()) >= lo_y and int(py.max()) < hi_y
        assert torch.equal(px, px.round()) and torch.equal(py, py.round())
        assert int(idx.min()) >= 0 and int(idx.max()) < 3
        assert (idx.unique().numel() == 1) == single_image
        torch.testing.assert_close(batch["target"], images[idx, py.long(), px.long()],
                                   rtol=0, atol=0)

    def test_n_images_limits_the_draw(self):
        gen = torch.Generator().manual_seed(1)
        batch = device_sampling.sample_batch_on_device(self._images(), gen, 400, n_images=2,
                                                       single_image=False)
        assert set(batch["img_idx"].tolist()) == {0, 1}

    def test_sampling_step_trains_from_a_generator(self):
        """``make_device_sampling_step`` around the port's step: each call
        draws its batch and its randoms from the one generator; the same seed
        gives the same run."""
        rng = np.random.default_rng(16)
        images = torch.from_numpy(_image(rng).astype(np.float32))
        losses = []
        for _ in range(2):
            tp = bridge.train_params_to_torch(jax.tree.map(np.asarray, jax_params()),
                                              device="cpu")
            train_cfg = tstep.TrainConfig(near=2.0, far=6.0, weight_decay=0.1)
            optimizer = toptim.Optimizer.from_config(train_cfg)
            base = tstep.make_train_step(T_MODEL, T_RENDER, train_cfg, tcur.Curriculum(),
                                         optimizer)
            step = device_sampling.make_device_sampling_step(base, images, 32)
            state = tstep.create_train_state(tp, optimizer)
            gen = torch.Generator().manual_seed(7)
            run = []
            for _ in range(3):
                state, metrics = step(state, gen)
                assert set(metrics) == {"loss", "mse", "mse0", "psnr"}
                run.append(float(metrics["loss"]))
            assert state.step == 3 and np.isfinite(run).all()
            losses.append(run)
        assert losses[0] == losses[1]
