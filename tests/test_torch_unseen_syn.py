"""Port parity: ``DATA_SEL.TEST_QUERY_DB: unseen_syn``, the query set that
generate synthesizes from the validation db with the test-time background
mix and IR, against the JAX package's memmaps on the CPU (f32, a tiny
encoder). The JAX package draws batch i's mix from ``PRNGKey(i)``; the
test takes those draws and injects them into the port's chain."""
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np

from nafp_tpu.configuration import load_config
from test_torch_augment import _jax_bg_draws

FS = 8000
NAME, INDEX = "syn", 2
# f32 encoder on both sides, FFT and sums in other orders, unit-norm rows
MEMMAP_ATOL = 2e-5


def _write_wav(path, x):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def test_unseen_syn_queries_match_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    rng = np.random.default_rng(4)
    t = np.arange(int(FS * 4.5)) / FS
    for i in range(3):
        _write_wav(f"{root}/music/val-query-db-500-30s/db/{i}.wav",
                   0.5 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                   + 0.05 * rng.standard_normal(len(t)))
    for i in range(2):
        _write_wav(f"{root}/aug/bg/ts/{i}.wav",
                   0.3 * rng.standard_normal(len(t)))
        _write_wav(f"{root}/aug/ir/ts/{i}.wav", 0.3 * np.exp(
            -np.arange(800) / 90.0) * rng.standard_normal(800))
    cfg = load_config("default")
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                      BG_ROOT_DIR=f"{root}/aug/bg/",
                      IR_ROOT_DIR=f"{root}/aug/ir/",
                      OUTPUT_ROOT_DIR=f"{root}/emb/",
                      LOG_ROOT_DIR=f"{root}/logs/")
    cfg["DATA_SEL"]["TEST_QUERY_DB"] = "unseen_syn"
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=[8, 8, 16, 16, 32, 32,
                                                    64, 64],
                        MIXED_PRECISION=False)
    cfg["BSZ"]["TS_BATCH_SZ"] = 8          # 24 segments: 3 batches
    cfg["DEVICE"].update(MESH_DATA_PARALLEL=1, DEVICE_CORPUS=False)

    import nafp_tpu.generate as jgen
    from nafp_tpu.models.nnfp import get_fingerprinter
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        get_fingerprinter(cfg).init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 256, 32, 1))))
    monkeypatch.setattr(jgen, "load_params",
                        lambda cfg, name, index, model, mcfg:
                        (variables, INDEX))
    jax_dir = jgen.generate_fingerprint(cfg, NAME, INDEX, skip_dummy=True,
                                        output_root_dir=f"{root}/emb_jax/")

    import nafp_tpu_torch.generate as pgen
    from nafp_tpu_torch.models.convert import save_params_npz
    from nafp_tpu_torch.ops.tdaug import augment_replicas
    save_params_npz(f"{root}/logs/checkpoint/{NAME}/{INDEX}/params.npz",
                    variables)
    calls = []

    def injected(xp, bg, ir, gen, snr_range, **kw):
        draws = _jax_bg_draws(jax.random.PRNGKey(len(calls)), xp.shape[0],
                              snr_range)
        calls.append(gen.initial_seed())
        return augment_replicas(xp, bg, ir, gen, snr_range, **kw, **draws)

    monkeypatch.setattr(pgen, "augment_replicas", injected)
    port_dir = pgen.generate_fingerprint(cfg, NAME, INDEX, skip_dummy=True,
                                         device="cpu")
    assert calls == [0, 1, 2]               # batch i's generator seed is i

    from nafp_tpu_torch.data.audio_io import load_memmap
    for key in ("query", "db"):
        a, sa = load_memmap(jax_dir, key, display=False)
        b, sb = load_memmap(port_dir, key, display=False)
        assert sa == sb == (24, 16)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=MEMMAP_ATOL, rtol=0, err_msg=key)
    q, db = (np.asarray(load_memmap(port_dir, k, display=False)[0])
             for k in ("query", "db"))
    assert np.abs(q - db).max() > 1e-3      # the queries are degraded
