"""Support for the port's test modules (``tests/test_torch_*.py``).

- :func:`hang_watchdog`, an autouse fixture each of those modules imports.
  If one test runs longer than ``TEST_TIMEOUT_S``, ``faulthandler`` prints
  every thread's stack to the worker's own stderr (copied once with
  pytest's capture suspended, so the dump reaches the terminal or log
  instead of the test's captured output) and ends the process. Under
  pytest-xdist the controller then reports ``worker 'gwN' crashed while
  running '<test id>'`` and goes on with the rest of the run, so a stuck
  test shows up by name as one failure instead of stalling the whole run
  until an outer time limit cuts it. No port test takes more than a few
  seconds alone.
- :func:`interpret`, the one way these modules run a JAX function that
  reaches a Pallas TPU kernel.
"""
from __future__ import annotations

import faulthandler
import os
import sys

import pytest

TEST_TIMEOUT_S = 300

_stderr = []


def _worker_stderr(config):
    if not _stderr:
        capman = config.pluginmanager.getplugin("capturemanager")
        if capman is None:
            _stderr.append(sys.stderr)
        else:
            with capman.global_and_fixture_disabled():
                _stderr.append(os.fdopen(os.dup(2), "w"))
    return _stderr[0]


@pytest.fixture(autouse=True)
def hang_watchdog(request):
    faulthandler.dump_traceback_later(TEST_TIMEOUT_S, exit=True,
                                      file=_worker_stderr(request.config))
    yield
    faulthandler.cancel_dump_traceback_later()


def interpret(fn):
    """``fn()``, JAX code that reaches a Pallas TPU kernel, run in TPU
    interpret mode as one jitted computation and waited for.

    Interpret mode runs the kernel through ordered ``io_callback``s, and
    those callbacks dispatch small JAX operations of their own
    (``jax/_src/pallas/mosaic/interpret/shared_memory.py:
    update_clocks_for_device_barrier`` multiplies a device id that arrives
    as a JAX array). JAX dispatches asynchronously: called eagerly, a
    function such as the NeRF++ renderer goes on dispatching operations on
    the kernel's output while the kernel's computation is still running.
    Now and then the two dispatches block each other for good: the hang
    caught had the test's thread inside the dispatch of a ``concatenate``
    on the renderer's samples and a callback thread inside its own
    multiply, both waiting. One jitted computation, waited for at once,
    leaves the test's thread nothing to dispatch while the callbacks run.
    """
    import jax
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)())
