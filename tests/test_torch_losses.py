"""The port's losses against the JAX package: ``se3_inverse``, the
photometric losses and PSNR, and PRD (``prd_pointwise``, ``prd_loss`` in
train and val modes, ``"NeRF"`` and ``"NeRF++"``), values and gradients
with respect to the rays, K and the extrinsics.

Same seeded numpy inputs into both. Values: relative 1e-5. Gradients:
relative L2 error per argument <= 1e-5 (elementwise relative error is the
wrong measure where a near-degenerate entry scales an ulp by 1/denominator).
The degenerate rows (near-parallel rays, a projection depth within 1e-6 of
0, points behind a camera, padded entries) meet every overflow guard; their
gradients must be finite on both sides and agree.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.geometry import so3 as jso3  # noqa: E402
from scnerf_tpu.losses import photometric as jphoto  # noqa: E402
from scnerf_tpu.losses import prd as jprd  # noqa: E402
from scnerf_tpu_torch.geometry import so3 as tso3  # noqa: E402
from scnerf_tpu_torch.losses import photometric as tphoto  # noqa: E402
from scnerf_tpu_torch.losses import prd as tprd  # noqa: E402

RTOL = 1e-5
F = 20.0  # focal of the PRD cameras
C = 8.0  # principal point (16x16 images)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def _pair_poses():
    """Two c2w poses a short baseline apart, turned a little."""
    E = np.tile(np.eye(4), (2, 1, 1))
    E[1, :3, :3] = _rotation([0.2, 1.0, 0.1], 0.15)
    E[1, :3, 3] = [0.6, 0.05, -0.1]
    return E


def _ray_to(o, p):
    d = p - o
    return d / np.linalg.norm(d)


def _project(p, c2w, method):
    """Pixel of world point ``p`` in a camera: OpenGL (the camera looks down
    -z, y up) for "NeRF", OpenCV for "NeRF++"."""
    cam = np.linalg.inv(c2w) @ np.append(p, 1.0)
    if method == "NeRF":
        return np.array([C - F * cam[0] / cam[2], C + F * cam[1] / cam[2]])
    return np.array([C + F * cam[0] / cam[2], C + F * cam[1] / cam[2]])


def prd_inputs(method, n=12, seed=0, degenerate=False):
    """Correspondences of points in front of both cameras, keypoints moved
    by about a pixel; with ``degenerate``, rows that meet every guard."""
    rng = np.random.default_rng(seed)
    E = _pair_poses()
    o0, o1 = E[0, :3, 3], E[1, :3, 3]
    forward = -1.0 if method == "NeRF" else 1.0
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                    forward * rng.uniform(3.0, 5.0, n)], -1)
    kps0 = np.stack([_project(p, E[0], method) for p in pts]) + rng.normal(size=(n, 2))
    kps1 = np.stack([_project(p, E[1], method) for p in pts]) + rng.normal(size=(n, 2))
    d0 = np.stack([_ray_to(o0, p) for p in pts]) + rng.normal(size=(n, 3)) * 1e-3
    d1 = np.stack([_ray_to(o1, p) for p in pts]) + rng.normal(size=(n, 3)) * 1e-3
    O0 = np.tile(o0, (n, 1))
    O1 = np.tile(o1, (n, 1))
    mask = np.ones(n, bool)
    if degenerate:
        # Near-parallel rays: the triangulation denominator's floor.
        d1[0] = d0[0] + 1e-7
        d1[1] = d0[1]
        # A point on camera 1's z = 0 plane: the projection's depth floor.
        R1, t1 = E[1, :3, :3], E[1, :3, 3]
        p = t1 + R1 @ np.array([0.7, 0.3, 0.0])
        d0[2] = _ray_to(o0, p)
        d1[2] = _ray_to(o1, p)
        # Behind both cameras: chirality 0.
        d0[3] = -d0[3]
        d1[3] = -d1[3]
        # Nearly parallel rays 1000 apart: |t| beyond its bound, and the
        # squared error beyond its cap.
        side = np.cross(d0[4], [0.0, 1.0, 0.0])
        side /= np.linalg.norm(side)
        O1[4] = O0[4] + 1e3 * side
        d1[4] = d0[4] - 5e-3 * side
        # Padded entries with garbage in them.
        mask[-2:] = False
        kps0[-1] = kps1[-1] = 0.0
        O0[-1] = O1[-1] = 0.0
    K = np.array([[F, 0, C, 0], [0, F, C, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(kps0=f32(kps0), kps1=f32(kps1), rays=[f32(O0), f32(d0), f32(O1), f32(d1)],
                K=f32(K), E=f32(E), mask=mask)


def _run_both(inputs, fn_j, fn_t):
    """``fn(o0, d0, o1, d1, K, E)`` -> scalar on both sides: values and the
    gradients into all six arguments."""
    args = [*inputs["rays"], inputs["K"], inputs["E"]]
    value_j, grads_j = jax.value_and_grad(fn_j, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))
    leaves = [_t(a, grad=True) for a in args]
    value_t = fn_t(*leaves)
    grads_t = torch.autograd.grad(value_t, leaves)
    return (float(value_j), [np.asarray(g) for g in grads_j],
            float(value_t.detach()), [g.numpy() for g in grads_t])


def _assert_close(inputs, fn_j, fn_t):
    value_j, grads_j, value_t, grads_t = _run_both(inputs, fn_j, fn_t)
    np.testing.assert_allclose(value_t, value_j, rtol=RTOL)
    for name, gj, gt in zip(("o0", "d0", "o1", "d1", "K", "E"), grads_j, grads_t):
        assert np.isfinite(gj).all() and np.isfinite(gt).all(), name
        assert _rel_l2(gt, gj) <= RTOL, (name, _rel_l2(gt, gj))


class TestSE3:
    def test_inverse_matches_jax(self):
        rng = np.random.default_rng(0)
        E = np.tile(np.eye(4), (5, 1, 1))
        for i in range(5):
            E[i, :3, :3] = _rotation(rng.normal(size=3), rng.uniform(0, 3))
        E[:, :3, 3] = rng.normal(size=(5, 3))
        E = E.astype(np.float32)
        got = tso3.se3_inverse(_t(E))
        np.testing.assert_allclose(got.numpy(), np.asarray(jso3.se3_inverse(jnp.asarray(E))),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose((got @ _t(E)).numpy(), np.tile(np.eye(4), (5, 1, 1)),
                                   atol=1e-5)

    def test_gradient_matches_jax(self):
        rng = np.random.default_rng(1)
        E = _pair_poses().astype(np.float32)
        cot = rng.normal(size=(2, 4, 4)).astype(np.float32)
        want = jax.grad(lambda e: jnp.sum(jso3.se3_inverse(e) * cot))(jnp.asarray(E))
        leaf = _t(E, grad=True)
        (got,) = torch.autograd.grad(torch.sum(tso3.se3_inverse(leaf) * _t(cot)), leaf)
        assert _rel_l2(got.numpy(), want) <= RTOL


class TestPhotometric:
    def test_mse_psnr_and_masked_mse(self):
        rng = np.random.default_rng(2)
        pred = rng.random((64, 3)).astype(np.float32)
        target = rng.random((64, 3)).astype(np.float32)
        mask = rng.random(64) < 0.6
        mse_j = jphoto.img2mse(jnp.asarray(pred), jnp.asarray(target))
        mse_t = tphoto.img2mse(_t(pred), _t(target))
        np.testing.assert_allclose(float(mse_t), float(mse_j), rtol=RTOL)
        np.testing.assert_allclose(float(tphoto.mse2psnr(mse_t)),
                                   float(jphoto.mse2psnr(mse_j)), rtol=RTOL)
        np.testing.assert_allclose(
            float(tphoto.masked_mse(_t(pred), _t(target), torch.from_numpy(mask))),
            float(jphoto.masked_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))),
            rtol=RTOL)

    def test_psnr_floor_and_empty_mask(self):
        zero = np.zeros((4, 3), np.float32)
        assert float(tphoto.mse2psnr(torch.tensor(0.0))) == pytest.approx(
            float(jphoto.mse2psnr(jnp.asarray(0.0))), rel=RTOL)
        assert float(tphoto.mse2psnr(torch.tensor(0.0))) == pytest.approx(120.0, rel=RTOL)
        empty = np.zeros(4, bool)
        assert float(tphoto.masked_mse(_t(zero + 1), _t(zero), torch.from_numpy(empty))) == 0.0

    def test_masked_mse_gradient(self):
        rng = np.random.default_rng(3)
        pred = rng.random((32, 3)).astype(np.float32)
        target = rng.random((32, 3)).astype(np.float32)
        mask = rng.random(32) < 0.5
        want = jax.grad(lambda p: jphoto.masked_mse(p, jnp.asarray(target), jnp.asarray(mask)))(
            jnp.asarray(pred))
        leaf = _t(pred, grad=True)
        (got,) = torch.autograd.grad(
            tphoto.masked_mse(leaf, _t(target), torch.from_numpy(mask)), leaf)
        assert _rel_l2(got.numpy(), want) <= RTOL


METHODS = ["NeRF", "NeRF++"]


class TestPRD:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("degenerate", [False, True])
    def test_pointwise(self, method, degenerate):
        inp = prd_inputs(method, degenerate=degenerate)
        kps0, kps1 = inp["kps0"], inp["kps1"]
        rng = np.random.default_rng(4)
        cots = rng.normal(size=(3, kps0.shape[0])).astype(np.float32)
        if degenerate:
            # The near-parallel rows' partials into the origins are rounding
            # residues (d0 - r01 d1 cancels to ~1e-7) over the floored
            # denominator, different in every summation order. prd_loss
            # drops those rows (their loss is far past the threshold), so
            # they carry a zero cotangent here as there: the 0 * inf path.
            cots[:, :2] = 0.0

        def fn_j(o0, d0, o1, d1, K, E):
            l0, l1, ch = jprd.prd_pointwise(jnp.asarray(kps0), jnp.asarray(kps1), (o0, d0),
                                            (o1, d1), K, E, method=method)
            return jnp.sum(l0 * cots[0]) + jnp.sum(l1 * cots[1]) + jnp.sum(ch * cots[2])

        def fn_t(o0, d0, o1, d1, K, E):
            l0, l1, ch = tprd.prd_pointwise(_t(kps0), _t(kps1), (o0, d0), (o1, d1), K, E,
                                            method=method)
            c = _t(cots)
            return torch.sum(l0 * c[0]) + torch.sum(l1 * c[1]) + torch.sum(ch * c[2])

        _assert_close(inp, fn_j, fn_t)
        # Each output on its own, values.
        args = [*inp["rays"], inp["K"], inp["E"]]
        want = jprd.prd_pointwise(jnp.asarray(kps0), jnp.asarray(kps1),
                                  tuple(jnp.asarray(a) for a in args[:2]),
                                  tuple(jnp.asarray(a) for a in args[2:4]),
                                  jnp.asarray(args[4]), jnp.asarray(args[5]), method=method)
        got = tprd.prd_pointwise(_t(kps0), _t(kps1), tuple(_t(a) for a in args[:2]),
                                 tuple(_t(a) for a in args[2:4]), _t(args[4]), _t(args[5]),
                                 method=method)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)
        if degenerate:
            ch = got[2].numpy()
            assert ch[3] == 0.0  # behind the cameras
            assert ch[2] == ch[4] == 1.0  # on the z = 0 plane; |t| clipped
            assert got[1][2] == 1e8  # the capped squared error

    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("mode", ["train", "val"])
    @pytest.mark.parametrize("degenerate", [False, True])
    def test_loss(self, method, mode, degenerate):
        inp = prd_inputs(method, seed=5, degenerate=degenerate)
        kps0, kps1, mask = inp["kps0"], inp["kps1"], inp["mask"]
        counts = {}

        def fn_j(o0, d0, o1, d1, K, E):
            loss, num = jprd.prd_loss(jnp.asarray(kps0), jnp.asarray(kps1), (o0, d0), (o1, d1),
                                      K, E, mask=jnp.asarray(mask), method=method, mode=mode)
            counts["jax"] = num
            return loss

        def fn_t(o0, d0, o1, d1, K, E):
            loss, num = tprd.prd_loss(_t(kps0), _t(kps1), (o0, d0), (o1, d1), K, E,
                                      mask=torch.from_numpy(mask), method=method, mode=mode)
            counts["port"] = float(num)
            return loss

        _assert_close(inp, fn_j, fn_t)
        value_j, grads_j, value_t, grads_t = _run_both(inp, fn_j, fn_t)
        assert value_t > 0.0
        # The count, on its own (the JAX one is a tracer under grad).
        args = [jnp.asarray(a) for a in [*inp["rays"], inp["K"], inp["E"]]]
        _, num = jprd.prd_loss(jnp.asarray(kps0), jnp.asarray(kps1), tuple(args[:2]),
                               tuple(args[2:4]), args[4], args[5], mask=jnp.asarray(mask),
                               method=method, mode=mode)
        assert counts["port"] == float(num)
        assert counts["port"] >= 4

    @pytest.mark.parametrize("method", METHODS)
    def test_no_valid_match(self, method):
        """A pair whose matches are all padded: loss 0, count 0, zero and
        finite gradients on both sides."""
        inp = prd_inputs(method, n=6, seed=6, degenerate=True)
        inp["mask"][:] = False
        kps0, kps1, mask = inp["kps0"], inp["kps1"], inp["mask"]

        def fn_j(o0, d0, o1, d1, K, E):
            return jprd.prd_loss(jnp.asarray(kps0), jnp.asarray(kps1), (o0, d0), (o1, d1),
                                 K, E, mask=jnp.asarray(mask), method=method)[0]

        def fn_t(o0, d0, o1, d1, K, E):
            loss, num = tprd.prd_loss(_t(kps0), _t(kps1), (o0, d0), (o1, d1), K, E,
                                      mask=torch.from_numpy(mask), method=method)
            assert float(num) == 0.0
            return loss

        value_j, grads_j, value_t, grads_t = _run_both(inp, fn_j, fn_t)
        assert value_t == value_j == 0.0
        for gj, gt in zip(grads_j, grads_t):
            assert np.isfinite(gt).all() and not np.abs(gt).any()
            assert not np.abs(gj).any()

    def test_degenerate_rows_meet_the_guards(self):
        """The rows built to be degenerate do reach the guards: the floored
        denominator (rows 0, 1), a depth within 1e-6 of zero (row 2), |t|
        past its bound (row 4)."""
        inp = prd_inputs("NeRF", degenerate=True)
        o0, d0, o1, d1 = (a.astype(np.float64) for a in inp["rays"])
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        r01 = (d0 * d1).sum(-1)
        assert (r01[:2] ** 2 - 1.0 > -1e-4).all()
        o_diff = o0 - o1
        denom = np.minimum(r01**2 - 1.0 + 1e-10, -1e-4)
        t0 = ((d0 * o_diff).sum(-1) - r01 * (d1 * o_diff).sum(-1)) / denom
        assert abs(t0[4]) > 1e4
        E = _pair_poses()
        p = E[1, :3, 3] + E[1, :3, :3] @ np.array([0.7, 0.3, 0.0])
        assert abs((np.linalg.inv(E[1]) @ np.append(p, 1.0))[2]) < 1e-6

    def test_distortion_k_raises(self):
        """``distortion_k`` without the image size it needs raises (the
        distortion-aware variant itself is held to JAX in
        ``tests/test_torch_nerfpp_train.py``)."""
        inp = prd_inputs("NeRF++", n=4)
        rays = [_t(a) for a in inp["rays"]]
        with pytest.raises(ValueError, match="image_wh"):
            tprd.prd_loss(_t(inp["kps0"]), _t(inp["kps1"]), tuple(rays[:2]), tuple(rays[2:]),
                          _t(inp["K"]), _t(inp["E"]), method="NeRF++",
                          distortion_k=torch.tensor([0.1, 0.0]))
