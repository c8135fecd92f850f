"""The port's own spans and counters (``nafp_tpu_torch.utils.profiling``)
on the CPU:

- nothing is recorded while no profiler records, and every span is then
  one shared no-op;
- under ``torch.profiler.profile``: totals and counts of nested spans,
  each span a host event of the profiler that starts within 1 ms of the
  span's entry and lasts the span's total;
- the profiler's flag is thread-local: a worker thread records nothing,
  and ``prefetch`` hands its decode seconds to the consumer, which adds
  them to ``loader.decode_s``;
- a ``device=True`` span off the card records host time and no device
  time;
- a FlatIndex search, ``hits_for_block``, ``generate_fingerprint`` and a
  ``TrainStep`` each record their named spans and no counter but the
  loader's (and, on the card, the re-rank kernel's
  ``query.rerank_fused``);
- ``device_summary`` (``device_profile``'s arithmetic) counts kernels,
  copies and memsets only, never the user annotations the profiler
  mirrors onto the device's timeline.
"""
import os
import threading
import time
import wave

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nafp_tpu_torch.utils import profiling as P

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_tracer():
    P.reset()
    yield
    P.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans():
    return P.snapshot()["spans"]


def test_nothing_is_recorded_without_a_profiler():
    assert not P.recording()
    with P.span("t.outer") as a:
        with P.span("t.inner", device=True) as b:
            P.count("t.items", 3)
    assert a is b is P.span("t.other")          # one shared no-op
    assert P.snapshot() == {"spans": {}, "counts": {}}


def test_nested_spans_totals_counts_and_self_time():
    with _profile() as prof:
        assert P.recording()
        with P.span("warm-up"):           # the profiler's first range
            pass
        entered = {"t.outer": time.time_ns()}      # the profiler's clock
        with P.span("t.outer"):
            time.sleep(0.02)
            entered["t.inner"] = time.time_ns()
            with P.span("t.inner"):
                time.sleep(0.03)
            with P.span("t.inner"):
                time.sleep(0.01)
            P.count("t.items", 3)
            P.count("t.items")
    snap = P.snapshot()
    o, i = snap["spans"]["t.outer"], snap["spans"]["t.inner"]
    assert (o["n"], i["n"]) == (1, 2)
    assert i["total_s"] >= 0.04 and o["total_s"] >= 0.06
    assert o["total_s"] >= i["total_s"] + 0.02
    assert o["device_s"] is None and i["device_s"] is None
    assert snap["counts"] == {"t.items": 4}

    starts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("t."):
            starts.setdefault(e.name(), []).append(
                (e.start_ns(), e.duration_ns()))
    assert sorted(starts) == ["t.inner", "t.outer"]
    assert len(starts["t.inner"]) == 2
    for name, t in entered.items():
        start, dur = min(starts[name])
        assert abs(start - t) < 1_000_000, name
    (start, dur), = starts["t.outer"]
    assert abs(dur / 1e9 - o["total_s"]) < 1e-3


def test_the_flag_is_thread_local():
    seen = []

    def work():
        seen.append(P.recording())
        with P.span("t.thread"):
            P.count("t.thread")
    with _profile():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [False]
    assert P.snapshot() == {"spans": {}, "counts": {}}


class _SlowLoader:
    """A loader whose every batch takes ``delay`` seconds to decode."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        return {"i": i}


def test_prefetch_hands_decode_seconds_to_the_consumer():
    from nafp_tpu_torch.data.loader import prefetch
    with _profile():
        got = [b["i"] for b in prefetch(_SlowLoader(5, 0.01))]
    assert got == list(range(5))
    snap = P.snapshot()
    assert list(snap["counts"]) == ["loader.decode_s"]
    assert 0.05 <= snap["counts"]["loader.decode_s"] < 5.0
    # one wait per batch and one for the end of the stream
    assert snap["spans"]["loader.wait"]["n"] == 6
    # untraced, the loader yields the same batches and records nothing
    assert [b["i"] for b in prefetch(_SlowLoader(3, 0.0))] == [0, 1, 2]
    assert P.snapshot() == snap


def test_device_span_off_the_card_records_host_time_only():
    with _profile():
        with P.span("t.dev", device=True):
            time.sleep(0.01)
    s = _spans()["t.dev"]
    assert s["n"] == 1 and s["total_s"] >= 0.01
    if torch.cuda.is_available():
        assert s["device_s"] is not None and s["device_s"] >= 0
    else:
        assert s["device_s"] is None


def test_spanned_keeps_the_function():
    @P.spanned("t.fn")
    def fn(a, b=2):
        """doc"""
        return a + b
    assert fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert fn(1) == 3 and _spans() == {}
    with _profile():
        assert fn(1, b=5) == 6
    assert _spans()["t.fn"]["n"] == 1


# -- the program's spans ------------------------------------------------------
def _db(n=1200, d=16, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_flat_index_search_spans(monkeypatch):
    from nafp_tpu_torch.search import index as I
    monkeypatch.setattr(I.FlatIndex, "PALLAS_MIN_ROWS", 1000)   # B1's route
    db = _db()
    idx = I.FlatIndex(db, device=CPU)
    q = db[:700] + 0.01
    plain = idx.search(q, 5)
    with _profile():
        traced = idx.search(q, 5)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    snap = P.snapshot()
    s, w = snap["spans"]["index.search"], snap["spans"]["index.wait"]
    assert s["n"] == 1 and w["n"] == 2            # blocks of 512 and 188
    assert s["total_s"] >= w["total_s"]
    assert snap["counts"] == {}


@pytest.mark.parametrize("route", [
    "cpu", "host", pytest.param("card", marks=pytest.mark.gpu)],
    ids=["device-rerank", "host-rerank", "card-rerank"])
def test_hits_for_block_spans(monkeypatch, route):
    """The spans of a block on each re-rank route; the card's kernel counts
    one launch and one ``query.rerank_fused`` a block, the others none."""
    from nafp_tpu_torch.search import evaluate as E
    from nafp_tpu_torch.search import index as I
    dev = CPU
    if route == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (run with -m gpu on the card)")
        dev = torch.device("cuda", 0)
    monkeypatch.setattr(I.FlatIndex, "PALLAS_MIN_ROWS", 1000)
    assert E._hits_for_block is E.hits_for_block
    db = _db()
    idx = I.FlatIndex(db, device=dev)
    recon = None if route == "host" else torch.from_numpy(db).to(dev)
    query = db[:300] + 0.01
    ids = np.arange(0, 260, 2)[:128]
    E.reset_launches()
    plain = E.hits_for_block(idx, recon, db, query, ids, 3, 10)
    with _profile():
        pred = E.hits_for_block(idx, recon, db, query, ids, 3, 10)
    np.testing.assert_array_equal(pred, plain)
    assert (pred[:, 0] == ids).all()
    snap = P.snapshot()
    sp = snap["spans"]
    want = {"query.assemble", "query.rerank", "index.search", "index.wait"}
    want |= {"query.rerank_wait"} if recon is not None else set()
    assert set(sp) == want
    assert sp["query.assemble"]["n"] == 2
    assert all(sp[n]["n"] == 1 for n in want - {"query.assemble"})
    assert sp["index.search"]["total_s"] >= sp["index.wait"]["total_s"]
    fused = route == "card"
    assert snap["counts"] == ({"query.rerank_fused": 1} if fused else {})
    assert E.LAUNCHES["rerank"] == (2 if fused else 0)


def _tiny_cfg(root):
    from nafp_tpu_torch.configuration import load_config
    cfg = load_config("default")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=[8, 8, 16, 16, 32, 32,
                                                    64, 64],
                        MIXED_PRECISION=False)
    cfg["BSZ"].update(TR_BATCH_SZ=8, TR_N_ANCHOR=4, TS_BATCH_SZ=8)
    cfg["DEVICE"].update(MESH_DATA_PARALLEL=1, DEVICE_CORPUS=False,
                         SONG_CACHE_GB=0)
    cfg["DIR"]["LOG_ROOT_DIR"] = os.path.join(root, "logs")
    return cfg


def _write_wav(path, x, fs=8000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())


def test_generate_spans(tmp_path):
    from nafp_tpu_torch.generate import generate_fingerprint
    from nafp_tpu_torch.models.convert import save_params_npz, torch_to_flax
    from nafp_tpu_torch.models.nnfp import get_fingerprinter
    root = str(tmp_path)
    cfg = _tiny_cfg(root)
    rng = np.random.default_rng(2)
    for i in range(2):
        _write_wav(f"{root}/src/{i}.wav",
                   0.3 * rng.standard_normal(8000 * 4))    # 7 segments
    save_params_npz(f"{root}/logs/checkpoint/tiny/0/params.npz",
                    torch_to_flax(get_fingerprinter(cfg).state_dict()))
    with _profile():
        out = generate_fingerprint(cfg, "tiny", 0,
                                   source_root_dir=f"{root}/src",
                                   output_root_dir=f"{root}/out",
                                   assume_yes=True, device=CPU)
    assert int(np.load(os.path.join(out, "custom_source_shape.npy"))[0]) \
        == 14
    snap = P.snapshot()
    sp = snap["spans"]
    assert set(sp) == {"generate.setup", "generate.load_model",
                       "generate.wait", "loader.wait"}
    assert sp["generate.setup"]["n"] == sp["generate.load_model"]["n"] == 1
    assert sp["generate.wait"]["n"] == 2           # batches of 8: 8 + 6
    assert sp["loader.wait"]["n"] == 3             # and the stream's end
    setup, load = sp["generate.setup"], sp["generate.load_model"]
    assert setup["total_s"] >= load["total_s"] > 0
    assert list(snap["counts"]) == ["loader.decode_s"]
    assert snap["counts"]["loader.decode_s"] > 0


def test_train_step_spans(tmp_path):
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train import trainer as T
    cfg = _tiny_cfg(str(tmp_path))
    mel, spec, model, _ = T.build_fp(cfg)
    optimizer, schedule = build_optimizer(cfg, model, 10)
    loss_fn = T._make_loss_fn(cfg, mel, spec, model, train=True,
                              aug_keys=frozenset(("bg", "ir")))
    step = T.TrainStep(cfg, model, optimizer, schedule, loss_fn, CPU)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.standard_normal(
        (4, 600 if k == "ir" else 8000)).astype(np.float32) * 0.1)
        for k in ("anchors", "replicas", "bg", "ir")}
    with _profile():
        loss, _ = step(batch)
    assert torch.isfinite(loss) and step.step == 1
    sp = _spans()
    phases = ("train.augment", "train.forward", "train.backward",
              "train.optimizer")
    assert set(sp) == set(phases)
    for name in phases:
        assert sp[name]["n"] == 1 and sp[name]["total_s"] > 0
        assert sp[name]["device_s"] is None
    assert P.snapshot()["counts"] == {}


# -- device_profile's arithmetic ----------------------------------------------
class _Event:
    def __init__(self, name, dev, start, dur, kind=None, annotation=False):
        self._v = (name, dev, start, dur, annotation)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


@pytest.mark.parametrize("typed", [True, False],
                         ids=["activity_type", "user_annotation_flag"])
def test_device_summary_counts_no_user_annotation(typed):
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU

    def ev(name, dev, start, dur, kind):
        return _Event(name, dev, start, dur, kind if typed else None,
                      annotation=kind == "gpu_user_annotation")
    events = [
        ev("scan_kernel", cuda, 0, 2_000_000, "kernel"),
        ev("Memcpy HtoD", cuda, 1_000_000, 2_500_000, "gpu_memcpy"),
        ev("Memset", cuda, 5_000_000, 1_000_000, "gpu_memset"),
        # a span mirrored onto the device's timeline: no device work
        ev("train.step", cuda, 0, 9_000_000, "gpu_user_annotation"),
        ev("aten::mm", cpu, 0, 9_000_000, "cpu_op"),
    ]
    s = P.device_summary(events, wall_ms=10.0)
    assert s["device_busy_ms"] == pytest.approx(4.5)
    assert s["busy"] == pytest.approx(0.45)
    assert list(s["by_name"]) == ["Memcpy HtoD", "scan_kernel", "Memset"]
    assert s["by_name"]["scan_kernel"] == (2.0, 1)
