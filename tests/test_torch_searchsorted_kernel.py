"""K4's port (``scnerf_tpu_torch/kernels/searchsorted_cuda.py``) against the
JAX package's Pallas kernel
``scnerf_tpu/kernels/searchsorted_pallas.py:searchsorted_pallas``, run in
interpret mode on the CPU: exact equality of the indices, both sides.

On CPU tensors the port's wrapper takes its plain twin; the CUDA kernel is
held to the twin on the card (``tests/test_torch_kernels.py``, marked
``cuda``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog, interpret  # noqa: E402,F401
from scnerf_tpu.kernels.searchsorted_pallas import searchsorted_pallas  # noqa: E402
from scnerf_tpu_torch.kernels import searchsorted_cuda  # noqa: E402


def _ties(rng, rows, n, m):
    """Rows with runs of repeated values, and queries drawn from the rows'
    own entries as often as between them."""
    a = np.sort(np.round(rng.random((rows, n)) * 8) / 8, axis=-1).astype(np.float32)
    v = np.where(rng.random((rows, m)) < 0.5,
                 np.take_along_axis(a, rng.integers(0, n, (rows, m)), -1),
                 rng.random((rows, m))).astype(np.float32)
    return a, v


def _uniform(seed, rows, n, m):
    """tests/test_kernels.py:TestSearchsortedPallas's draws."""
    rng = np.random.RandomState(seed)
    a = np.sort(rng.rand(rows, n).astype(np.float32), axis=-1)
    return a, rng.rand(rows, m).astype(np.float32)


CASES = {
    "rows_64": lambda: _uniform(0, 64, 63, 64),
    "non_divisible_rows": lambda: _uniform(1, 100, 33, 17),
    "ties": lambda: _ties(np.random.default_rng(2), 40, 63, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("side", ["left", "right"])
def test_matches_interpret_mode_kernel(case, side):
    a, v = CASES[case]()
    want = np.asarray(interpret(
        lambda: searchsorted_pallas(jnp.asarray(a), jnp.asarray(v), side, row_block=32)))
    before = searchsorted_cuda.launches
    got = searchsorted_cuda.searchsorted_cuda(torch.from_numpy(a), torch.from_numpy(v), side)
    assert searchsorted_cuda.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
