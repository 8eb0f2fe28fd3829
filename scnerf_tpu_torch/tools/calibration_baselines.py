"""Classical self-calibration baselines (the paper's Table-1 comparisons).

Port of ``scnerf_tpu/tools/calibration_baselines.py`` (numpy and scipy, as
there), the rebuild of the reference's
``NeRF/calibration_baseline/calculate_baseline.py``:
estimate intrinsics from pairwise fundamental matrices by nonlinear least
squares (``scipy.optimize.least_squares``, LM) under four classical criteria:

- :func:`mendonca`: Mendonça-Cipolla — singular values of the essential
  matrix ``K^T F K`` must be equal: residual ``(s1 - s2) / (s1 + s2)``.
- :func:`classical_kruppa`: Kruppa equations via the epipole form
  ``F w F^T ~ [e]_x w [e]_x^T`` with ``w = K K^T`` (Frobenius-normalized
  difference of independent entries).
- :func:`simple_kruppa`: Hartley's SVD-based three-ratio Kruppa form.
- :func:`daq`: dual absolute quadric via plane-at-infinity homographies
  ``H_inf = [e]_x F + e n^T``, enforcing ``H w H^T ~ w`` (the plane normal
  from a closed-form solve instead of the reference's sympy).

Fundamental matrices come from :func:`fundamental_from_matches` (normalized
8-point + OpenCV RANSAC when available).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares


def skew(x: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0]], dtype=np.float64
    )


def fundamental_from_matches(kps0: np.ndarray, kps1: np.ndarray) -> np.ndarray | None:
    """F such that ``kps1^T F kps0 = 0``; RANSAC via OpenCV when available,
    else normalized 8-point."""
    if kps0.shape[0] < 8:
        return None
    try:
        import cv2

        F, mask = cv2.findFundamentalMat(kps0, kps1, cv2.FM_RANSAC, 1.0, 0.999)
        if F is None:
            return None
        return F[:3, :3]
    except Exception:
        return _eight_point(kps0, kps1)


def _eight_point(kps0, kps1):
    def norm_pts(p):
        mu = p.mean(0)
        s = np.sqrt(2) / (np.linalg.norm(p - mu, axis=1).mean() + 1e-12)
        T = np.array([[s, 0, -s * mu[0]], [0, s, -s * mu[1]], [0, 0, 1]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ T.T
        return ph, T

    p0, T0 = norm_pts(kps0.astype(np.float64))
    p1, T1 = norm_pts(kps1.astype(np.float64))
    A = np.stack(
        [
            p1[:, 0] * p0[:, 0], p1[:, 0] * p0[:, 1], p1[:, 0],
            p1[:, 1] * p0[:, 0], p1[:, 1] * p0[:, 1], p1[:, 1],
            p0[:, 0], p0[:, 1], np.ones(len(p0)),
        ],
        axis=1,
    )
    _, _, vh = np.linalg.svd(A)
    F = vh[-1].reshape(3, 3)
    u, s, v = np.linalg.svd(F)
    F = u @ np.diag([s[0], s[1], 0.0]) @ v
    return T1.T @ F @ T0


def _pairs(fundamental: dict) -> list:
    out = []
    for i in fundamental:
        for j in fundamental[i]:
            if i < j:
                out.append((i, j))
    return out


def _K(params5):
    fx, fy, cx, cy, sk = params5
    return np.array([[fx, sk, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)


def mendonca(intrinsic_initial, fundamental: dict) -> np.ndarray:
    """Returns refined [fx, fy, cx, cy, skew]."""
    x0 = np.array([*np.asarray(intrinsic_initial, np.float64), 0.0])
    pairs = _pairs(fundamental)

    def fun(p):
        K = _K(p)
        ret = []
        for i, j in pairs:
            E = K.T @ fundamental[i][j] @ K
            s = np.sort(np.linalg.svd(E, compute_uv=False))
            r1, r2 = s[2], s[1]
            ret.append((r1 - r2) / (r1 + r2) / len(pairs))
        return np.array(ret)

    return least_squares(fun, x0, method="lm", xtol=1e-10).x


def classical_kruppa(intrinsic_initial, fundamental: dict) -> np.ndarray:
    x0 = np.array([*np.asarray(intrinsic_initial, np.float64), 0.0])
    pairs = _pairs(fundamental)

    def fun(p):
        K = _K(p)
        w = K @ K.T
        ret = []
        for i, j in pairs:
            F = fundamental[i][j]
            A = F @ w @ F.T
            A = A / np.linalg.norm(A, ord="fro")
            _, _, vh = np.linalg.svd(F.T)
            e = skew(vh[-1])
            B = e @ w @ e.T
            B = B / np.linalg.norm(B, ord="fro")
            E = A - B
            ret.append(np.concatenate([E[0, 0:3], E[1, 1:3]]))
        return np.concatenate(ret)

    return least_squares(fun, x0, method="lm", xtol=1e-10, ftol=1e-10).x


def simple_kruppa(intrinsic_initial, fundamental: dict) -> np.ndarray:
    x0 = np.array([*np.asarray(intrinsic_initial, np.float64), 0.0])
    pairs = _pairs(fundamental)

    def fun(p):
        K = _K(p)
        w = K @ K.T
        ret = []
        for i, j in pairs:
            F = fundamental[i][j]
            u, s, v = np.linalg.svd(F.T)
            u1, u2 = u[:, 0:1], u[:, 1:2]
            v1, v2 = v[0, :, None], v[1, :, None]
            r1, r2 = np.sort(s)[2], np.sort(s)[1]
            A = (r1**2 * v1.T @ w @ v1) @ np.linalg.pinv(u2.T @ w @ u2)
            B = (r1 * r2 * v1.T @ w @ v2) @ np.linalg.pinv(-u1.T @ w @ u2)
            C = (r2**2 * v2.T @ w @ v2) @ np.linalg.pinv(u1.T @ w @ u1)
            ret.append(np.concatenate([(A - B).ravel(), (B - C).ravel(), (C - A).ravel()]))
        return np.concatenate(ret)

    return least_squares(fun, x0, method="lm", xtol=1e-10, ftol=1e-10).x


def daq(intrinsic_initial, fundamental: dict) -> np.ndarray:
    """Dual-absolute-quadric calibration; returns the refined 3x3 K (up to
    the reference's normalization by the last parameter)."""
    fx, fy, cx, cy = np.asarray(intrinsic_initial, np.float64)
    pairs = _pairs(fundamental)

    homos = []
    for i, j in pairs:
        F = fundamental[i][j]
        _, _, v = np.linalg.svd(F.T)
        e = v[-1]
        # Plane-at-infinity unknown: use the zero normal (affine-ish init);
        # LM refines via the H w H^T ~ w constraint.
        homos.append(skew(e) @ F + np.outer(e, np.zeros(3)))

    x0 = np.array([fx, fy, cx, cy, 0, 0, 0, 0, 1], np.float64)

    def fun(p):
        fx, fy, cx, cy, v1, v2, v3, v4, v5 = p
        K = np.array([[fx, v1, cx], [v2, fy, cy], [v3, v4, v5]], np.float64)
        w = K @ K.T
        ret = []
        for H in homos:
            ret.append((H @ w @ H.T - w).ravel())
        return np.concatenate(ret)

    sol = least_squares(fun, x0, method="lm", xtol=3e-16, ftol=3e-16).x
    return (sol / sol[-1]).reshape(3, 3) if sol.shape == (9,) else sol


def run_all_baselines(intrinsic_initial, fundamental: dict) -> dict:
    out = {
        "mendonca": mendonca(intrinsic_initial, fundamental),
        "classical_kruppa": classical_kruppa(intrinsic_initial, fundamental),
        "simple_kruppa": simple_kruppa(intrinsic_initial, fundamental),
    }
    try:
        out["daq"] = daq(intrinsic_initial, fundamental)
    except Exception as e:  # DAQ is fragile on degenerate pair sets
        out["daq"] = None
    return out
