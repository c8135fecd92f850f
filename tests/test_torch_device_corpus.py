"""Port parity: the device-resident corpus of nafp_tpu_torch.

The port's gathered batches must equal, bit for bit, both its own host
loader's batches and the JAX package's ``DeviceGatherLoader``'s, for every
case of ``tests/test_device_corpus.py``; a read past a padded song end
raises; the budget gate keeps the host loader; the trainer and generate
take the device corpus through ``DEVICE.DEVICE_CORPUS``. On the CPU the
corpus lives in host memory: the gather is the same torch code the card
runs."""
import glob
import json
import os
import wave

import numpy as np
import pytest
import torch

from nafp_tpu.data.device_corpus import DeviceGatherLoader as JaxGather
from nafp_tpu.data.loader import SegmentLoader as JaxLoader
from nafp_tpu_torch.data.device_corpus import (DeviceCorpus,
                                               DeviceGatherLoader,
                                               corpus_nbytes,
                                               maybe_device_loader)
from nafp_tpu_torch.data.loader import SegmentLoader, prefetch

FS = 8000
CPU = torch.device("cpu")


def _write_wav(path, seconds, f0=440.0, fs=FS):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = np.arange(int(fs * seconds)) / fs
    # broadband-ish content, so an off-by-one slice is visible
    x = (0.4 * np.sin(2 * np.pi * f0 * t)
         + 0.3 * np.sin(2 * np.pi * 3.1 * f0 * t + 0.5))
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("devcorpus"))
    for i in range(5):   # different lengths -> padded corpus rows
        _write_wav(f"{r}/music/{i:03d}.wav", 4.0 + 0.7 * i, 250 + 80 * i)
    for i in range(2):
        _write_wav(f"{r}/bg/{i}.wav", 3.0, 60 + 15 * i)
        _write_wav(f"{r}/ir/{i}.wav", 0.05, 1200)  # 400 frames < 600 pad
        _write_wav(f"{r}/speech/{i}.wav", 2.0, 120 + 30 * i)
    return r


def _music(root):
    return sorted(glob.glob(root + "/music/*.wav"))


def _train_kw(root):
    return dict(fns_event_list=_music(root), bsz=8, n_anchor=4,
                duration=1.0, hop=0.5, fs=FS, shuffle=True,
                random_offset_anchor=True,
                bg_fps=sorted(glob.glob(root + "/bg/*.wav")),
                ir_fps=sorted(glob.glob(root + "/ir/*.wav")),
                speech_fps=sorted(glob.glob(root + "/speech/*.wav")))


CASES = {
    # bg, IR and speech on; batches 0, 1 and the last; an epoch reshuffle
    "train": (_train_kw, (0, 1, -1), 3),
    # the now_playing layout: 4 replicas per anchor (bsz 120, 24 anchors
    # scaled down), bg, IR and speech on
    "train_4_per_anchor": (lambda r: {**_train_kw(r), "bsz": 10,
                                      "n_anchor": 2}, (0, 1, -1), 2),
    # anchors only, a short last batch (the padding mask)
    "db_short_last": (lambda r: dict(
        fns_event_list=_music(r), bsz=16, n_anchor=16, duration=1.0,
        hop=0.5, fs=FS, drop_the_last_non_full_batch=False), (-1,), None),
    # the unseen_syn query loader: anchors dropped, replicas gathered
    "query_synth": (lambda r: dict(
        fns_event_list=_music(r), bsz=8, n_anchor=4, duration=1.0,
        hop=0.5, fs=FS, reduce_batch_first_half=True,
        experimental_mode=True), (0, 1), None),
}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _batches_equal(want, got):
    assert set(want) == set(got)
    assert int(want["n_valid"]) == int(got["n_valid"])
    for k in want:
        if k != "n_valid":
            np.testing.assert_array_equal(
                _np(got[k]), _np(want[k]),
                err_msg=f"key {k} differs between the loaders")


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_bit_exact_vs_host_and_jax(root, case):
    """Each batch gathered by the port equals its own host loader's and
    the JAX package's device loader's, bit for bit."""
    make_kw, idxs, epoch = CASES[case]
    kw = make_kw(root)
    host = SegmentLoader(**kw)
    dev = DeviceGatherLoader(SegmentLoader(**kw), device=CPU)
    jax_dev = JaxGather(JaxLoader(**kw))
    assert len(host) == len(dev) == len(jax_dev)
    if case == "db_short_last":
        assert int(host[len(host) - 1]["n_valid"]) < 16
    for stage in ((None,) if epoch is None else (None, epoch)):
        if stage is not None:
            for ld in (host, dev, jax_dev):
                ld.set_epoch(stage)
        for i in idxs:
            i = i % len(host)
            got = dev[i]
            assert all(torch.is_tensor(got[k]) and got[k].dtype ==
                       torch.float32 for k in got if k != "n_valid")
            _batches_equal(host[i], got)
            _batches_equal(jax_dev[i], got)


def test_zero_stand_ins_made_once(root):
    """The query-synthesis loader's empty anchors are one tensor reused by
    every batch, not a fresh allocation per step."""
    kw = CASES["query_synth"][0](root)
    dev = DeviceGatherLoader(SegmentLoader(**kw), device=CPU)
    assert dev[0]["anchors"] is dev[1]["anchors"]
    assert not dev[0]["anchors"].any()


def test_corpus_rows_padded_and_exact(root):
    from nafp_tpu_torch.data.audio_io import load_wav_segment, wav_info
    fps = _music(root)
    c = DeviceCorpus(fps, FS, device=CPU)
    assert c.data.dtype == torch.int16 and c.length % 128 == 0
    n0, _ = wav_info(fps[0])
    row = c.data[c.row[fps[0]]].numpy().astype(np.float32) / 32768.0
    np.testing.assert_array_equal(row[:n0],
                                  load_wav_segment(fps[0], 0, n0, FS))
    assert (row[n0:] == 0).all()
    assert corpus_nbytes(fps) == c.data.shape[0] * c.data.shape[1] * 2


def test_read_past_row_end_raises(root):
    """A start past the padded row end would read the next song: it
    raises instead."""
    kw = CASES["db_short_last"][0](root)
    dev = DeviceGatherLoader(SegmentLoader(**kw), device=CPU)
    plan = dev.base.plan_batch(0)
    paths, starts = plan["anchors"]
    bad = list(starts)
    bad[0] = dev._ev.length - dev.base.seg_len + 1
    with pytest.raises(ValueError, match="past padded song end"):
        dev._gather(dev._ev, (paths, bad), dev.base.n_anchor,
                    plan["n_valid"], dev.base.seg_len)
    ok = list(starts)
    ok[0] = dev._ev.length - dev.base.seg_len      # the last legal start
    dev._gather(dev._ev, (paths, ok), dev.base.n_anchor, plan["n_valid"],
                dev.base.seg_len)


def test_budget_gate(root, capsys):
    ld = SegmentLoader(fns_event_list=_music(root), bsz=4, n_anchor=4,
                       duration=1.0, hop=0.5, fs=FS)
    assert maybe_device_loader(ld, {"DEVICE": {}}) is ld
    tiny = {"DEVICE": {"DEVICE_CORPUS": True, "DEVICE_CORPUS_MAX_GB": 1e-9}}
    assert maybe_device_loader(ld, tiny, device=CPU) is ld
    assert "exceeds DEVICE_CORPUS_MAX_GB" in capsys.readouterr().out
    wrapped = maybe_device_loader(ld, {"DEVICE": {"DEVICE_CORPUS": True}},
                                  device=CPU)
    assert isinstance(wrapped, DeviceGatherLoader)
    # attribute passthrough the trainer and generate rely on
    assert wrapped.bsz == 4 and wrapped.bg_mix is False
    _batches_equal(ld[0], wrapped[0])


def test_prefetch_thread_batches(root):
    """Batches gathered on prefetch's worker thread equal the host
    loader's, in order."""
    kw = _train_kw(root)
    host = SegmentLoader(**kw)
    dev = DeviceGatherLoader(SegmentLoader(**kw), device=CPU)
    got = list(prefetch(dev))
    assert len(got) == len(host)
    for i, b in enumerate(got):
        _batches_equal(host[i], b)


def test_uploader_passes_device_batches_through(root):
    from nafp_tpu_torch.train.trainer import BatchUploader
    dev = DeviceGatherLoader(SegmentLoader(**_train_kw(root)), device=CPU)
    b = dev[0]
    out = BatchUploader(CPU)(b)
    assert set(out) == {"anchors", "replicas", "bg", "ir", "speech"}
    assert all(out[k] is b[k] for k in out)


def test_cli_train_and_generate_with_device_corpus(tmp_path):
    """``cli train`` and ``generate`` with DEVICE.DEVICE_CORPUS on give the
    host loader's run: the same losses and weights after one epoch, the
    same memmaps."""
    import subprocess
    import sys

    import yaml
    from click.testing import CliRunner
    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.data.audio_io import load_memmap
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = str(tmp_path)
    subprocess.run([sys.executable,
                    os.path.join(repo, "extras", "make_synth_dataset.py"),
                    root, "--n_train", "4", "--n_query", "2", "--n_dummy",
                    "2", "--sec", "4"], check=True, stdout=subprocess.DEVNULL)
    runs = {}
    for on in (False, True):
        cfg = load_config("default")
        cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=[8, 8, 16, 16, 32,
                                                        32, 64, 64],
                            MIXED_PRECISION=False)
        cfg["BSZ"].update(TR_BATCH_SZ=8, TR_N_ANCHOR=4, VAL_BATCH_SZ=8,
                          VAL_N_ANCHOR=4, TS_BATCH_SZ=8)
        cfg["TRAIN"].update(MAX_EPOCH=1, TENSORBOARD=False,
                            MINI_TEST_IN_TRAIN=False)
        cfg["DEVICE"].update(SONG_CACHE_GB=0, DEVICE_CORPUS=on)
        cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                          BG_ROOT_DIR=f"{root}/aug/bg/",
                          IR_ROOT_DIR=f"{root}/aug/ir/",
                          OUTPUT_ROOT_DIR=f"{root}/emb{int(on)}/",
                          LOG_ROOT_DIR=f"{root}/logs{int(on)}/")
        path = f"{root}/c{int(on)}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        for cmd in (["train", "t", "-c", path, "--nogpu"],
                    ["generate", "t", "-c", path, "--nogpu", "--yes"]):
            res = CliRunner().invoke(main, cmd)
            assert res.exit_code == 0, res.output + repr(res.exception)
            assert ("resident" in res.output) == on
        (metrics,) = glob.glob(f"{root}/logs{int(on)}/fit/t/*/metrics.jsonl")
        with open(metrics) as f:
            runs[on] = {m["tag"]: m["value"] for m in map(json.loads, f)
                        if m["tag"].startswith("loss/")}
        runs[on]["params"] = dict(np.load(
            f"{root}/logs{int(on)}/checkpoint/t/1/params.npz"))
    assert runs[True]["loss/train"] == runs[False]["loss/train"]
    assert runs[True]["loss/val"] == runs[False]["loss/val"]
    for k, v in runs[False]["params"].items():
        np.testing.assert_array_equal(runs[True]["params"][k], v)
    for key in ("dummy_db", "db", "query"):
        a, _ = load_memmap(f"{root}/emb1/t/1", key, display=False)
        b, _ = load_memmap(f"{root}/emb0/t/1", key, display=False)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
