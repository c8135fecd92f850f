"""Port parity: generate's fingerprint pass over several devices
(``DEVICE.MESH_DATA_PARALLEL``) and the batch-wide log-mel max it needs.

- ``melspectrogram_parts`` over a batch split in parts equals
  ``melspectrogram`` of the whole batch (the max and the maxnorm minimum
  are the whole batch's) within 1e-6;
- ``data_devices``: -1 is every local device, n CPU devices on the CPU,
  more cards than the host has raises;
- ``generate --nogpu`` over two CPU devices with ``TS_BATCH_SZ`` 5 (odd:
  every batch takes the pad row) writes the memmaps of one device within
  2e-5, and those of the JAX package's generate sharded over the 8-device
  CPU mesh (``MESH_DATA_PARALLEL`` 8, its own pad path) within 2e-5 (f32
  encoders, sums in other orders: tests/test_torch_slice.py's bound).
"""

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from test_torch_slice import _song, _write_wav

NAME, INDEX = "gen", 2
MEMMAP_ATOL = 2e-5
PARTS_ATOL = 1e-6


@pytest.mark.parametrize("feat", ["melspec", "melspec_maxnorm"])
def test_melspec_parts_equal_the_whole_batch(feat):
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.ops.melspec import (get_melspec_fn,
                                            melspectrogram_parts)
    cfg = load_config("default")
    cfg["MODEL"]["FEAT"] = feat
    fn, mcfg = get_melspec_fn(cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((7, 8000))
                          * np.linspace(0.01, 1, 7)[:, None]).astype(
                             np.float32))                 # loudest row last
    whole = fn(x)
    for cuts in ([3], [1, 4], [2, 3, 5]):
        parts = melspectrogram_parts(list(torch.tensor_split(x, cuts)), mcfg)
        np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                                   atol=PARTS_ATOL, rtol=0)
    # each part normalised by its own max would not be the batch's
    alone = fn(x[:3])
    assert np.abs(alone.numpy() - whole[:3].numpy()).max() > 1e-3


def test_data_devices(monkeypatch):
    from nafp_tpu_torch.parallel import mesh as M
    cpu = torch.device("cpu")
    cfg = lambda n: {"DEVICE": {"MESH_DATA_PARALLEL": n}}
    assert M.data_devices(cfg(-1), "cpu") == [cpu]
    assert M.data_devices(None, "cpu") == [cpu]
    assert M.data_devices(cfg(3), "cpu") == [cpu] * 3
    assert M.local_devices("cpu") == [cpu]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert M.data_devices(cfg(-1)) == cards
    assert M.data_devices(cfg(1)) == cards[:1]
    with pytest.raises(ValueError, match="exceeds the 2 local CUDA"):
        M.data_devices(cfg(3))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen"))
    rng = np.random.default_rng(1)
    for i in range(3):
        db = _song(700 + i, 4.5)
        _write_wav(f"{root}/music/test-query-db-500-30s/db/{i:02d}.wav", db)
        _write_wav(f"{root}/music/test-query-db-500-30s/query/{i:02d}.wav",
                   db + 0.05 * rng.standard_normal(len(db)))
    for i in range(2):
        _write_wav(f"{root}/music/test-dummy-db-100k-full/{i:02d}.wav",
                   _song(800 + i, 3.5))
    return root


def test_generate_over_two_devices(corpus):
    import jax
    import jax.numpy as jnp
    import nafp_tpu.generate as jgen
    from nafp_tpu.configuration import load_config
    from nafp_tpu.models.nnfp import get_fingerprinter
    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.data.audio_io import load_memmap
    from nafp_tpu_torch.models.convert import save_params_npz

    cfg = load_config("default")
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{corpus}/music/",
                      LOG_ROOT_DIR=f"{corpus}/logs/")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=[8, 8, 16, 16, 32, 32,
                                                    64, 64],
                        MIXED_PRECISION=False)
    cfg["BSZ"]["TS_BATCH_SZ"] = 5
    cfg["DEVICE"]["DEVICE_CORPUS"] = False
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        get_fingerprinter(cfg).init)(jax.random.PRNGKey(5),
                                     jnp.zeros((1, 256, 32, 1), jnp.float32)))
    save_params_npz(f"{corpus}/logs/checkpoint/{NAME}/{INDEX}/params.npz",
                    variables)

    out = {}
    for n in (1, 2):
        cfg["DEVICE"]["MESH_DATA_PARALLEL"] = n
        cfg["DIR"]["OUTPUT_ROOT_DIR"] = f"{corpus}/port{n}/"
        path = f"{corpus}/port{n}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        res = CliRunner().invoke(main, ["generate", NAME, str(INDEX), "-c",
                                        path, "--yes", "--nogpu"])
        assert res.exit_code == 0, res.output + repr(res.exception)
        assert ("fingerprint pass over 2 devices" in res.output) == (n == 2)
        out[n] = f"{corpus}/port{n}/{NAME}/{INDEX}"

    cfg["DEVICE"]["MESH_DATA_PARALLEL"] = 8
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "load_params",
               lambda cfg, name, index, model, mcfg: (variables, INDEX))
    out["jax"] = jgen.generate_fingerprint(
        cfg, NAME, INDEX, assume_yes=True, output_root_dir=f"{corpus}/jax/")
    mp.undo()

    for key in ("dummy_db", "db", "query"):
        one, s1 = load_memmap(out[1], key, display=False)
        two, s2 = load_memmap(out[2], key, display=False)
        jx, sj = load_memmap(out["jax"], key, display=False)
        assert s1 == s2 == sj and s1[1] == 16 and s1[0] % 5   # a short batch
        np.testing.assert_allclose(np.asarray(two), np.asarray(one),
                                   atol=MEMMAP_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(np.asarray(two), np.asarray(jx),
                                   atol=MEMMAP_ATOL, rtol=0, err_msg=key)
