"""``llm_qat_torch.utils.benchmarking`` against the JAX package's
``utils/benchmarking.py``: the same functions and arguments, and the same
contract. Both are run under one injected host clock (a list of readings),
so the two must give the same number: the harness's total for ``iters`` runs
less the floor's, over ``iters``, clamped at 0. The card's path (a CUDA
graph timed between events) is ``tests/test_torch_cuda_kernels.py``'s."""

import inspect
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.utils import benchmarking as JB
from llm_qat_torch.utils import benchmarking as TB


class _Clock:
    """Readings in order: the floor's start and end, then the op's."""

    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self):
        return self.readings.pop(0)


def _both(readings, iters, reps, monkeypatch):
    monkeypatch.setattr(TB, "clock", _Clock(readings))
    monkeypatch.setattr(JB, "time", types.SimpleNamespace(perf_counter=_Clock(readings)))
    got = TB.measure(lambda x: x * 3.0, [torch.ones(4)], iters=iters, reps=reps)
    want = JB.measure(lambda x: x * 3.0, [jnp.ones(4)], iters=iters, reps=reps)
    return got, want


@pytest.mark.parametrize("iters,reps", [(5, 2), (8, 1)])
def test_measure_subtracts_the_floor_as_jax_does(iters, reps, monkeypatch):
    floor, total = 0.25, 1.5                       # seconds a rep
    readings = [10.0, 10.0 + reps * floor, 20.0, 20.0 + reps * total]
    got, want = _both(readings, iters, reps, monkeypatch)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx((total - floor) / iters, rel=1e-12)


def test_measure_clamps_at_zero_as_jax_does(monkeypatch):
    readings = [0.0, 3.0, 5.0, 6.0]                # the op's total under the floor's
    got, want = _both(readings, 4, 1, monkeypatch)
    assert got == want == 0.0


def test_a_given_floor_is_not_measured_and_the_op_runs_iters_times(monkeypatch):
    monkeypatch.setattr(TB, "clock", _Clock([1.0, 1.9]))
    calls = []

    def op(x):
        calls.append(1)
        return x + 1

    per = TB.measure(op, [torch.zeros(3)], iters=6, reps=3, floor=0.15)
    assert per == pytest.approx((0.3 - 0.15) / 6)
    assert len(calls) == 1 + 6 * 3                 # one warm run, then reps x iters
    monkeypatch.setattr(TB, "clock", time.perf_counter)
    assert TB.dispatch_floor(iters=3, reps=1, device="cpu") >= 0.0


def test_same_names_and_arguments_as_jax():
    for name in ("scan_time", "dispatch_floor", "measure"):
        jp = inspect.signature(getattr(JB, name)).parameters
        tp = inspect.signature(getattr(TB, name)).parameters
        assert list(jp) == [p for p in tp if p != "device"], name
        for p, jpar in jp.items():
            assert tp[p].default == jpar.default and tp[p].kind == jpar.kind, (name, p)


def test_cpu_total_is_the_host_clock(monkeypatch):
    monkeypatch.setattr(TB, "clock", _Clock([2.0, 2.6]))
    assert TB.scan_time(lambda x: x, [torch.ones(1)], iters=10, reps=3) == pytest.approx(0.2)
    monkeypatch.setattr(TB, "clock", time.perf_counter)
    assert np.isfinite(TB.measure(lambda x: x @ x, [torch.ones(8, 8)], iters=3, reps=1))
