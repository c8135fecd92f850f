"""The port's train-step microbench
(``nafp_tpu_torch/extras/bench_train_step.py``) on the CPU: one measured
step at a tiny plan returns the JAX script's keys with a finite loss, and
``--probe`` halves the batch only on ``torch.cuda.OutOfMemoryError``."""
import json

import numpy as np
import pytest
import torch

from nafp_tpu_torch.configuration import load_config
from nafp_tpu_torch.extras import bench_train_step as BT

JAX_KEYS = {"bsz", "step_ms", "segments_per_sec", "loss_finite",
            "hbm_in_use_gib", "hbm_limit_gib", "backend"}


def test_measure_tiny_plan_on_cpu():
    cfg = load_config("640_lamb")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=[8, 8, 8, 8, 16, 16, 16,
                                                    16],
                        MIXED_PRECISION=False)
    row = BT.measure(cfg, 8, 1, torch.device("cpu"))
    assert JAX_KEYS <= set(row)
    assert row["bsz"] == 8 and row["loss_finite"] is True
    assert np.isfinite(row["step_ms"]) and row["step_ms"] > 0
    # both fields are rounded (0.01 ms, 0.1 segments/s)
    assert row["segments_per_sec"] == pytest.approx(
        8 / row["step_ms"] * 1e3, rel=1e-2, abs=0.05)
    # the CPU has no device memory record: the empty form
    assert row["hbm_in_use_gib"] is None and row["backend"] == "cpu"


def _fake_measure(fail):
    calls = []

    def measure(cfg, bsz, steps, device=None):
        calls.append(bsz)
        if bsz > 1280:
            raise fail
        return {"bsz": bsz, "step_ms": 1.0}
    return measure, calls


def test_probe_halves_on_out_of_memory(monkeypatch, capsys):
    measure, calls = _fake_measure(torch.cuda.OutOfMemoryError("oom"))
    monkeypatch.setattr(BT, "measure", measure)
    row = BT.main(["-c", "tpu_5120", "--probe", "--cpu"])
    assert calls == [5120, 2560, 1280] and row["bsz"] == 1280
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["bsz"] for r in lines] == [5120, 2560, 1280]
    assert "error" in lines[0] and "error" not in lines[-1]


def test_probe_reraises_other_errors(monkeypatch):
    measure, calls = _fake_measure(ValueError("not a memory error"))
    monkeypatch.setattr(BT, "measure", measure)
    with pytest.raises(ValueError, match="not a memory error"):
        BT.main(["-c", "tpu_5120", "--probe", "--cpu"])
    assert calls == [5120]


def test_out_of_memory_without_probe_propagates(monkeypatch):
    measure, calls = _fake_measure(torch.cuda.OutOfMemoryError("oom"))
    monkeypatch.setattr(BT, "measure", measure)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        BT.main(["-c", "tpu_5120", "--cpu"])
    assert calls == [5120]
