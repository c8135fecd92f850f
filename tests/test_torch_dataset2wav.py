"""Port parity: ``nafp_tpu_torch/extras/dataset2wav.py`` against the JAX
package's ``extras/dataset2wav.py`` on the CPU, on a tiny synthetic corpus
(the port's ``make_synth_dataset.py``): the same files, names and count
for ``--split val`` and ``--split test`` (n_pos 1 and 2), with JAX's
background-mix draws (``PRNGKey(seed + batch)``) injected through the
port's ``snr=``/``amp=`` hooks, and the WAVs read back through the port's
``data/audio_io.py``."""
import glob
import importlib.util
import os
import subprocess
import sys
import wave

import jax
import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from test_torch_augment import _jax_bg_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 42
# The augmented waveforms agree to ~1e-6 (tests/test_torch_augment.py:
# RMS sums and FFTs in other orders); PCM is the truncation of x·32767, so
# a sample within that of an integer boundary lands one LSB apart. Every
# file has the same length and header, at most LSB_SHARE_MAX of its
# samples differ, and by one LSB only (measured at most 0.61 % of a file's
# samples with --split val, 0.48 % with --split test).
LSB_SHARE_MAX = 0.01


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("d2w"))
    subprocess.run([sys.executable, os.path.join(
        REPO, "nafp_tpu_torch", "extras", "make_synth_dataset.py"), root,
        "--n_train", "0", "--n_query", "2", "--n_dummy", "0", "--sec", "3"],
        check=True, stdout=subprocess.DEVNULL)
    from nafp_tpu.configuration import load_config
    cfg = load_config("default")
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                      BG_ROOT_DIR=f"{root}/aug/bg/",
                      IR_ROOT_DIR=f"{root}/aug/ir/")
    cfg["BSZ"]["TS_BATCH_SZ"] = 4
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return root, path, cfg


def _jax_main():
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_dataset2wav", os.path.join(REPO, "extras", "dataset2wav.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod.main


def _pcm(path):
    with wave.open(path) as w:
        return (w.getparams(), np.frombuffer(w.readframes(w.getnframes()),
                                             np.int16))


@pytest.mark.parametrize("split,n_pos", [("val", 1), ("test", 2)])
def test_wavs_match_jax(corpus, tmp_path, split, n_pos):
    from nafp_tpu_torch.data.audio_io import load_wav_segment
    from nafp_tpu_torch.extras import dataset2wav as P
    root, cfg_path, cfg = corpus
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    res = CliRunner().invoke(_jax_main(), [jdir, "-c", cfg_path, "--split",
                                           split, "--n_pos", str(n_pos)])
    assert res.exit_code == 0, res.output + repr(res.exception)
    snr = tuple(cfg["TD_AUG"]["VAL_SNR" if split == "val" else "TS_SNR"])
    n = P.synthesize(cfg, pdir, split, n_pos, SEED, device="cpu",
                     draws=lambda bi, rows: _jax_bg_draws(
                         jax.random.PRNGKey(SEED + bi), rows, snr))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and len(names) == n
    # 8 validation songs (make_synth_dataset's minimum) or 2 test-db songs
    # of 3 s at a 0.5 s hop: 5 segments each, n_pos replicas each
    assert n == (8 if split == "val" else 2) * 5 * n_pos
    worst = 0.0
    for name in names:
        (jp, jx), (pp, px) = _pcm(f"{jdir}/{name}"), _pcm(f"{pdir}/{name}")
        assert jp == pp and len(jx) == len(px) == 8000
        diff = np.abs(px.astype(np.int32) - jx)
        assert diff.max() <= 1, (name, diff.max())
        worst = max(worst, float((diff > 0).mean()))
        x = load_wav_segment(f"{pdir}/{name}", 0, 8000, expected_fs=8000)
        np.testing.assert_array_equal(np.round(x * 32768).astype(np.int16),
                                      px)
    assert worst <= LSB_SHARE_MAX, worst


def test_cli_runs_on_the_cpu(corpus, tmp_path):
    from nafp_tpu_torch.extras.dataset2wav import main
    _, cfg_path, _ = corpus
    out = str(tmp_path / "wavs")
    res = CliRunner().invoke(main, [out, "-c", cfg_path, "--cpu"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    assert "wrote 40 augmented query WAVs" in res.output
    assert len(glob.glob(f"{out}/*.wav")) == 40
