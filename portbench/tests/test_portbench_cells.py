"""Every cell run end to end at a small size, on the CPU: correct as it
stands; not correct with its timed path broken underneath (a planted
fault) or with its control in the port's place; and a cell, traffic mix
and per-layer metric added from this test's own files.

The harness's look for a card is skipped: ``run.measure`` is driven on the
CPU with ``sizes`` that shrink the encoder's channels and the data. The
port runs in float32 here (``MIXED_PRECISION`` off), so a sound run reads
at rounding and the limits of the full-size cells stand.
"""
import json
import os
import shutil

import pytest
import torch

from portbench import control, registry, run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345              # more than 32 signed bits hold
SMALL = {"model": {"FRONT_HIDDEN_CH": [8, 8, 16, 16, 32, 32, 64, 128],
                   "MIXED_PRECISION": False}}
SIZES = {
    "l2-icassp": {**SMALL, "db": {"n_songs": 20, "song_sec": 10,
                                  "n_dummy": 2000}},
    "l2-ingest": {**SMALL, "n_songs": 12, "song_sec": 10},
    "lamb640-train": {**SMALL, "n_anchor": 8, "corpus_songs": 6,
                      "bg_clips": 3, "ir_clips": 4, "song_sec": 6},
}
BENCH = registry.benchmark()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(name, traced=False, bench=BENCH, base=registry.HERE, **kw):
    cell = registry.Cell(bench, name, base)
    return run.measure(cell, SEED, 1.0, traced, CPU,
                       {"sizes": SIZES.get(name, SIZES["l2-icassp"]), **kw})


def _failed(line):
    return {n for n, c in line["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(name, traced):
    line = _run(name, traced)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = registry.Cell(BENCH, name)
    want = {m["name"] for m in (cell.per_layer if traced
                                else cell.end_to_end)}
    if traced:        # shares of the card's time are left out on the CPU
        assert set(line["metrics"]) <= want
        assert list(line["breakdown"]) == ["device_ops", "idle_gaps"]
    else:
        assert set(line["metrics"]) == want
        assert line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "checks"


# -- planted faults ----------------------------------------------------------
def _alter_hits(monkeypatch):
    """A segment hit altered where the index produces it."""
    from nafp_tpu_torch.search import index
    plain = index.FlatIndex.search

    def search(self, q, k, *a, **kw):
        d, ids = plain(self, q, k, *a, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 7) % self.ntotal
        return d, ids
    monkeypatch.setattr(index.FlatIndex, "search", search)


def _alter_ranking(monkeypatch):
    """The ranked answer altered where the re-rank produces it: every
    clip's candidates scored in reverse."""
    from nafp_tpu_torch.search import evaluate
    plain = evaluate._score_candidates

    def score(*a, **kw):
        s, c = plain(*a, **kw)
        return torch.where(torch.isfinite(s), -s, s), c
    monkeypatch.setattr(evaluate, "_score_candidates", score)


def _alter_rows(monkeypatch):
    """A fingerprint altered where generate produces it: the first row of
    every batch rolled by one dimension."""
    from nafp_tpu_torch import generate
    plain = generate.build_model

    def build(*a, **kw):
        model = plain(*a, **kw)
        forward = model.forward

        def altered(x):
            e = forward(x).clone()
            e[0] = torch.roll(e[0], 1)
            return e
        model.forward = altered
        return model
    monkeypatch.setattr(generate, "build_model", build)


def _state_unchanged(monkeypatch):
    """A step that returns the optimizer's state unchanged."""
    from nafp_tpu_torch.optim import lamb
    monkeypatch.setattr(lamb.Lamb, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the loss taken over the rest."""
    from nafp_tpu_torch.train import trainer
    plain = trainer.ntxent_loss

    def half(ea, ep, tau=0.05, gathered=None, offset=0):
        n = ea.shape[0] // 2
        return plain(ea[:n], ep[:n], tau=tau)
    monkeypatch.setattr(trainer, "ntxent_loss", half)


@pytest.mark.parametrize("name,fault,caught", [
    ("l2-icassp", _alter_hits, "answer_gap"),
    ("l2-icassp", _alter_ranking, "answer_gap"),
    ("l2-ingest", _alter_rows, "row_gap"),
    ("lamb640-train", _state_unchanged, "change_gap"),
    ("lamb640-train", _half_batch, "loss_gap"),
], ids=["hit-altered", "answer-altered", "row-altered", "state-unchanged",
        "half-batch"])
def test_planted_fault_is_not_correct(monkeypatch, name, fault, caught):
    fault(monkeypatch)
    line = _run(name)
    assert not line["correct"]
    assert caught in _failed(line)


# -- controls ----------------------------------------------------------------
@pytest.mark.parametrize("name,kind,caught", [
    ("l2-icassp", "act_int8", "enc_gap"),
    ("l2-ingest", "act_int8", "row_gap"),
    ("lamb640-train", "fp8", "grad_gap"),
    ("lamb640-train", "half", "loss_gap"),
])
def test_control_is_not_correct(name, kind, caught):
    cell = registry.Cell(BENCH, name)
    checks = control.reading(cell, SEED, kind, 1.0, CPU, SIZES[name])
    failed = {n for n, c in checks.items() if not c["value"] <= c["limit"]}
    assert caught in failed


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run with -m gpu on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_tf32_control_is_not_correct_on_the_card(card):
    cell = registry.Cell(BENCH, "l2-icassp")
    sizes = {"db": {"n_songs": 60, "song_sec": 30, "n_dummy": 60000}}
    checks = control.reading(cell, SEED, "tf32", 2.0, card, sizes)
    failed = {n for n, c in checks.items() if not c["value"] <= c["limit"]}
    assert "answer_gap" in failed


# -- a cell added as files only ----------------------------------------------
def test_cell_added_from_its_own_files(tmp_path):
    base = tmp_path / "bench"
    for sub in ("traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(registry.HERE, sub), base / sub)
    traffic = json.load(open(base / "traffic" / "icassp-query.json"))
    traffic["seq_lens"] = [19]
    json.dump(traffic, open(base / "traffic" / "icassp-query-long.json",
                           "w"))
    limits = json.load(open(base / "workloads" / "l2-icassp.json"))
    json.dump(limits, open(base / "workloads" / "l2-icassp-long.json", "w"))
    (base / "metrics" / "query.long_blocks.py").write_text(
        "def read(ctx):\n    return float(len(ctx.counts['blocks']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "l2-icassp-long",
                               "config": "nnfp-icassp-l2",
                               "traffic": "icassp-query-long", "chips": 1,
                               "why": "19-segment clips only"})
    for m in bench["end_to_end"]:
        if "l2-icassp" in m.get("workloads", []):
            m["workloads"].append("l2-icassp-long")
    bench["per_layer"].append({
        "name": "query.long_blocks", "unit": "blocks", "better": "higher",
        "source": "program_counter", "layer": "protocol",
        "moves": "query_clips_per_s", "workloads": ["l2-icassp-long"]})
    line = _run("l2-icassp-long", traced=True, bench=bench, base=str(base))
    assert line["correct"], line["checks"]
    assert line["metrics"]["query.long_blocks"]["value"] >= 1
    assert "query.search_pct" not in line["metrics"]
