"""The port's axis-angle and Euler conversions (``geometry/so3.py``)
against the JAX package's.

The same seeded float32 numpy inputs go into both. Tolerance atol 1e-6: the
values are O(1) float32, and the two packages' sin, cos, arccos and atan2
may differ in the last bit. Covered: batched shapes, angles shaped
``(...,)`` and ``(..., 1)``, angle 0 (the axis norm's floor), angles within
1e-3 of pi, Euler angles at the gimbal lock (y = +-pi/2), and the round
trips the JAX package's own tests hold.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from scnerf_tpu.geometry import so3 as jso3  # noqa: E402
from scnerf_tpu_torch import geometry as tgeometry  # noqa: E402
from scnerf_tpu_torch.geometry import so3 as tso3  # noqa: E402

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _axes(rng, shape):
    a = rng.normal(size=shape + (3,))
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _angles(rng, shape):
    """Seeded angles in (0, pi), with 0 and angles within 1e-3 of pi among
    them."""
    ang = rng.uniform(0.01, 3.0, size=shape)
    flat = ang.reshape(-1)
    flat[:4] = [0.0, np.pi - 1e-3, np.pi - 1e-4, np.pi - 5e-4]
    return ang.astype(np.float32)


def test_the_four_conversions_are_exported_as_in_jax():
    import scnerf_tpu.geometry as jgeometry

    for name in ("axis_angle_to_rotation", "rotation_to_axis_angle",
                 "euler_to_rotation", "rotation_to_euler"):
        assert hasattr(jgeometry, name)
        assert getattr(tgeometry, name) is getattr(tso3, name)


class TestAxisAngle:
    @pytest.mark.parametrize("shape", [(7,), (2, 5)])
    @pytest.mark.parametrize("keepdim", [False, True], ids=["angle(...)", "angle(...,1)"])
    def test_axis_angle_to_rotation(self, shape, keepdim):
        rng = np.random.default_rng(0)
        axis, angle = _axes(rng, shape), _angles(rng, shape)
        if keepdim:
            angle = angle[..., None]
        got = tso3.axis_angle_to_rotation(torch.from_numpy(axis), torch.from_numpy(angle))
        want = jso3.axis_angle_to_rotation(jnp.asarray(axis), jnp.asarray(angle))
        assert got.shape == shape + (3, 3) == want.shape
        _close(got, want)

    def test_python_angles_as_in_jax(self):
        axis = np.array([[0.0, 0.0, 1.0]], np.float32)
        got = tso3.axis_angle_to_rotation(torch.from_numpy(axis), [np.pi / 2])
        want = jso3.axis_angle_to_rotation(jnp.asarray(axis), jnp.array([jnp.pi / 2]))
        _close(got, want)
        # 90 degrees about z takes x to y (the JAX package's golden case).
        _close(got[0] @ torch.tensor([1.0, 0.0, 0.0]), [0.0, 1.0, 0.0])

    @pytest.mark.parametrize("shape", [(9,), (3, 4)])
    def test_rotation_to_axis_angle(self, shape):
        rng = np.random.default_rng(1)
        R = np.array(jso3.axis_angle_to_rotation(jnp.asarray(_axes(rng, shape)),
                                                 jnp.asarray(_angles(rng, shape))))
        got_axis, got_angle = tso3.rotation_to_axis_angle(torch.from_numpy(R))
        want_axis, want_angle = jso3.rotation_to_axis_angle(jnp.asarray(R))
        assert got_axis.shape == shape + (3,) and got_angle.shape == shape
        _close(got_angle, want_angle)
        # Within 1e-3 of pi the axis is the skew part over ~2e-3, so a
        # different rounding in either package would show here first.
        _close(got_axis, want_axis)

    def test_angle_zero_takes_the_norm_floor(self):
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
        got_axis, got_angle = tso3.rotation_to_axis_angle(torch.from_numpy(R))
        want_axis, want_angle = jso3.rotation_to_axis_angle(jnp.asarray(R))
        _close(got_angle, want_angle)
        _close(got_axis, want_axis)
        assert not got_axis.any() and not got_angle.any()

    def test_round_trip(self):
        """``axis_angle_to_rotation(rotation_to_axis_angle(R)) == R``, as
        ``tests/test_geometry.py`` holds it for the JAX package."""
        rng = np.random.default_rng(2)
        axis = _axes(rng, (8,))
        angle = rng.uniform(0.01, 3.0, 8).astype(np.float32)
        R = tso3.axis_angle_to_rotation(torch.from_numpy(axis), torch.from_numpy(angle))
        R2 = tso3.axis_angle_to_rotation(*tso3.rotation_to_axis_angle(R))
        _close(R2, R, atol=1e-4)
        jR = jso3.axis_angle_to_rotation(jnp.asarray(axis), jnp.asarray(angle))
        _close(R2, jso3.axis_angle_to_rotation(*jso3.rotation_to_axis_angle(jR)), atol=1e-4)


def _euler(rng, shape):
    e = rng.uniform(-np.pi, np.pi, size=shape + (3,))
    e[..., 1] = rng.uniform(-np.pi / 2, np.pi / 2, size=shape)
    flat = e.reshape(-1, 3)
    flat[0, 1], flat[1, 1] = np.pi / 2, -np.pi / 2  # gimbal lock
    return e.astype(np.float32)


class TestEuler:
    @pytest.mark.parametrize("shape", [(6,), (2, 3)])
    def test_euler_to_rotation(self, shape):
        e = _euler(np.random.default_rng(3), shape)
        got = tso3.euler_to_rotation(torch.from_numpy(e))
        want = jso3.euler_to_rotation(jnp.asarray(e))
        assert got.shape == shape + (3, 3) == want.shape
        _close(got, want)

    @pytest.mark.parametrize("shape", [(6,), (2, 3)])
    def test_rotation_to_euler(self, shape):
        e = _euler(np.random.default_rng(4), shape)
        R = np.array(jso3.euler_to_rotation(jnp.asarray(e)))
        got = tso3.rotation_to_euler(torch.from_numpy(R))
        want = jso3.rotation_to_euler(jnp.asarray(R))
        assert got.shape == shape + (3,)
        _close(got, want)

    def test_gimbal_lock(self):
        """At y = +-pi/2 the x and z angles are not determined; both
        packages take the same pair from the same matrix, and the pair
        decodes to that matrix."""
        e = np.array([[0.4, np.pi / 2, -0.3], [-1.1, -np.pi / 2, 0.8]], np.float32)
        R = np.array(jso3.euler_to_rotation(jnp.asarray(e)))
        got = tso3.rotation_to_euler(torch.from_numpy(R))
        _close(got, jso3.rotation_to_euler(jnp.asarray(R)))
        _close(np.abs(got[:, 1].numpy()), np.full(2, np.pi / 2), atol=1e-3)
        _close(tso3.euler_to_rotation(got), R, atol=1e-3)

    def test_round_trip(self):
        """``euler_to_rotation(rotation_to_euler(R)) == R`` on the JAX
        package's two cases, and the angles come back exactly away from the
        gimbal lock."""
        e = torch.tensor([[0.3, -0.2, 0.7], [0.0, 0.1, -0.4]])
        R = tso3.euler_to_rotation(e)
        _close(tso3.euler_to_rotation(tso3.rotation_to_euler(R)), R, atol=1e-5)
        _close(tso3.rotation_to_euler(R), e, atol=1e-6)
        jR = jso3.euler_to_rotation(jnp.asarray(e.numpy()))
        _close(R, jR)
