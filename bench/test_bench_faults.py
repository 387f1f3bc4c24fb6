"""The check of the check, on the CPU at a small size in float32 (where
the sound program reads the reference to rounding, so the cells' limits
separate): with the timed path broken underneath (a step that leaves its
state unchanged, half of each worker's rows left out, no exchange
between the workers, a peel cut to no round that leaves every set
coordinate to the estimate) a run's ``correct`` comes out false, and the
unbroken program's true; the control (the plain reference in float8 in
the program's place) reads outside the cell's limits."""

import dataclasses
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402
import reference as ref_lib  # noqa: E402
from test_bench_reference import WORKLOADS, small  # noqa: E402


def _unchanged(monkeypatch):
    from repro_torch.train import step as step_mod

    def no_update(state, grads, *args, **kwargs):
        return torch.zeros((), dtype=torch.float32)
    monkeypatch.setattr(step_mod, "apply_update", no_update)


def _half_batch(monkeypatch):
    from repro_torch.models import registry
    real = registry.model_api

    def api(cfg):
        a = real(cfg)

        def loss(tree, batch, **kw):
            half = batch["tokens"].shape[0] // 2
            return a.loss(tree, {k: v[:half] for k, v in batch.items()}, **kw)
        return dataclasses.replace(a, loss=loss)
    monkeypatch.setattr(registry, "model_api", api)


def _no_exchange(monkeypatch):
    from repro_torch.core.collectives import LocalWorkers
    monkeypatch.setattr(LocalWorkers, "sum", lambda self, parts: parts[0].clone())
    monkeypatch.setattr(LocalWorkers, "bor", lambda self, parts: parts[0].clone())


def _no_peel(monkeypatch):
    real = harness.program_configs

    def configs(cfg, mix, seed):
        mcfg, tc = real(cfg, mix, seed)
        comp = dataclasses.replace(tc.compression, rounds=0)
        return mcfg, dataclasses.replace(tc, compression=comp)
    monkeypatch.setattr(harness, "program_configs", configs)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "no_exchange": _no_exchange,
          "no_peel": _no_peel}


def _run(workload):
    files = small(workload)
    part = harness.run_cell(files["config"], files["mix"], files["limits"], 2**31 + 11,
                            0.3, False, "cpu")
    return harness.judge(part["readings"], files["limits"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_program_is_correct(workload):
    assert _run(workload)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    verdict = _run(workload)
    assert not verdict["correct"], verdict


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    files = small(workload)
    cfg, mix = files["config"], files["mix"]
    batches = ref_lib.make_batches(cfg, mix["global_batch"], mix["seq_len"], 3,
                                   range(mix["check_steps"]))
    ref = ref_lib.train_readings(cfg, mix, 3, batches, "cpu")
    control = ref_lib.train_readings(cfg, mix, 3, batches, "cpu", prec="fp8")
    verdict = harness.judge(ref_lib.compare(control, ref), files["limits"])
    assert not verdict["correct"], verdict
