"""The ported slice as a whole, against the JAX package on the CPU:
WAV corpus -> generate (same Flax params; the port reads them from
params.npz) -> evaluate, plus the port's device rule and its import
hygiene (no jax, no nafp_tpu)."""
import os
import re
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from nafp_tpu.configuration import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 8000
NAME, INDEX = "slice", 3
# Memmap tolerance: f32 encoder on both sides, sums in other orders.
MEMMAP_ATOL = 2e-5


def _write_wav(path, x):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())


def _song(seed, sec):
    r = np.random.default_rng(seed)
    t = np.arange(int(FS * sec)) / FS
    x = sum(r.uniform(0.2, 0.5) * np.sin(2 * np.pi * r.uniform(100, 3500) * t
                                         + r.uniform(0, 6))
            for _ in range(3))
    return 0.8 * x / np.abs(x).max()


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Corpus + config + Flax params; the JAX package's generate output and
    the port's (through its CLI, --nogpu)."""
    root = str(tmp_path_factory.mktemp("slice"))
    rng = np.random.default_rng(0)
    for i in range(4):
        db = _song(200 + i, 5.5)
        _write_wav(f"{root}/music/test-query-db-500-30s/db/{i:02d}.wav", db)
        _write_wav(f"{root}/music/test-query-db-500-30s/query/{i:02d}.wav",
                   db + 0.05 * rng.standard_normal(len(db)))
    for i in range(3):
        _write_wav(f"{root}/music/test-dummy-db-100k-full/{i:02d}.wav",
                   _song(300 + i, 4.0))
    cfg = load_config("default")
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                      OUTPUT_ROOT_DIR=f"{root}/emb/",
                      LOG_ROOT_DIR=f"{root}/logs/")
    cfg["MODEL"].update(EMB_SZ=32, FRONT_HIDDEN_CH=[16, 16, 32, 32, 32, 32,
                                                    64, 64],
                        MIXED_PRECISION=False)
    cfg["BSZ"]["TS_BATCH_SZ"] = 16            # last batches are padded
    cfg["DEVICE"].update(MESH_DATA_PARALLEL=1, DEVICE_CORPUS=False)
    cfg_path = os.path.join(root, "slice.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    from nafp_tpu.models.nnfp import get_fingerprinter
    model = get_fingerprinter(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 256, 32, 1), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    import nafp_tpu.generate as jgen
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "load_params",
               lambda cfg, name, index, model, mcfg: (variables, INDEX))
    jax_dir = jgen.generate_fingerprint(
        cfg, NAME, INDEX, assume_yes=True,
        output_root_dir=f"{root}/emb_jax/")
    mp.undo()

    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.models.convert import save_params_npz
    save_params_npz(f"{root}/logs/checkpoint/{NAME}/{INDEX}/params.npz",
                    variables)
    res = CliRunner().invoke(main, ["generate", NAME, "-c", cfg_path,
                                    "--yes", "--nogpu"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    return dict(root=root, cfg_path=cfg_path, jax_dir=jax_dir,
                port_dir=f"{root}/emb/{NAME}/{INDEX}")


def test_generate_memmaps_match_jax(slice_run):
    from nafp_tpu.data.audio_io import load_memmap
    for key in ("dummy_db", "db", "query"):
        a, sa = load_memmap(slice_run["jax_dir"], key, display=False)
        b, sb = load_memmap(slice_run["port_dir"], key, display=False)
        assert sa == sb and sa[1] == 32 and sa[0] > 16   # padded batches
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=MEMMAP_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("index_type", ["l2", "sq8"])
def test_evaluate_raw_score_identical(slice_run, index_type):
    """Both packages' evaluate on their own memmaps give one raw_score."""
    import nafp_tpu.search.evaluate as JE
    from nafp_tpu_torch.cli import main
    JE.eval_fingerprints(slice_run["jax_dir"], index_type=index_type,
                         test_ids="all", test_seq_len="1 3 5")
    res = CliRunner().invoke(main, ["evaluate", NAME, str(INDEX), "-c",
                                    slice_run["cfg_path"], "-i", index_type,
                                    "-t", "all", "--test_seq_len", "1 3 5",
                                    "--nogpu"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    for name in ("raw_score.npy", "test_ids.npy"):
        a = np.load(os.path.join(slice_run["port_dir"], name))
        b = np.load(os.path.join(slice_run["jax_dir"], name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert os.path.exists(os.path.join(slice_run["port_dir"],
                                       "eval_summary.json"))


@pytest.mark.parametrize("verb", ["generate", "evaluate",
                                  "evaluate-default"])
def test_cli_without_nogpu_needs_a_card(slice_run, verb):
    """Without --nogpu and without a card every command (evaluate with the
    default -i ivfpq too) stops with "no CUDA device"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nafp_tpu_torch.cli import main
    args = [verb.split("-")[0], NAME, str(INDEX), "-c", slice_run["cfg_path"]]
    if verb == "evaluate":
        args += ["-i", "l2"]
    res = CliRunner().invoke(main, args)
    assert isinstance(res.exception, RuntimeError)
    assert "no CUDA device" in str(res.exception)


def test_cli_train_not_ported():
    from nafp_tpu_torch.cli import main
    res = CliRunner().invoke(main, ["train", "x", "-c", "default"])
    assert res.exit_code != 0 and "training slice" in res.output


def test_max_ir_length_matches_jax():
    from nafp_tpu.ops.tdaug import MAX_IR_LENGTH as J
    from nafp_tpu_torch.data.loader import MAX_IR_LENGTH as P
    assert P == J == 600


def _port_sources():
    pkg = os.path.join(REPO, "nafp_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_sources_import_neither_jax_nor_nafp_tpu():
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|nafp_tpu)"
                     r"(\.|\s|$)", re.M)
    files = _port_sources()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            hit = bad.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_port_modules_load_without_jax():
    """Importing every module of the port (and chip_smoke.py) leaves jax
    and nafp_tpu out of sys.modules."""
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").replace(
            ".__init__", "")
        for p in _port_sources() if not p.endswith("chip_smoke.py"))
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'nafp_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def test_device_rules():
    from nafp_tpu_torch.device import device_recon_budget, resolve_device
    assert resolve_device(nogpu=True) == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_recon_budget(torch.device("cpu")) == 4 << 30
    assert device_recon_budget(torch.device("cuda", 0),
                               free_bytes=10 << 30) == 5 << 30
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:0")
