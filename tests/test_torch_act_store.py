"""Port parity: ``MODEL.ACT_STORE`` (int8 / fp8 activation storage of
inference) of nafp_tpu_torch.models.nnfp against the JAX package's, on
the CPU:

- ``_compress_act`` / ``_decompress_act`` bit for bit, from f32 and from
  bf16, at values past ±7.9 (the int8 clamp), past 448 (fp8's largest
  value: XLA rounds past it to NaN where PyTorch's cast saturates), at
  exact halves of a step (ties to even) and on random values;
- each ConvLayer, fed JAX's input, stores the same codes as JAX's but for
  rounding flips (a value within the two packages' summation error of a
  rounding boundary);
- the embeddings of the whole encoder against JAX's with the same
  ACT_STORE (MIXED_PRECISION false);
- the option works in inference only; ``cli generate --act_store``; and
  ``bench_quant --cpu`` prints the JAX script's keys.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from nafp_tpu.configuration import load_config
from nafp_tpu.models import nnfp as J
from nafp_tpu_torch.models import nnfp as P
from nafp_tpu_torch.models.convert import save_params_npz, torch_to_flax
from test_torch_convergence import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CH = [8, 8, 16, 16, 32, 32, 64, 64]
MODES = ("int8", "fp8")
EDGE = np.array([0.0, -0.0, 1 / 32, 3 / 32, 5 / 32, -1 / 32, -3 / 32,
                 7.90625, 7.9375, 7.96875, 8.0, -8.0, -7.96875, 100.0,
                 2 ** -6, 2 ** -9, 1.5 * 2 ** -9, 2.5 * 2 ** -9, 0.5 * 2 ** -9,
                 0.3 * 2 ** -9, 416.0, 432.0, 440.0, 448.0, 452.0, 456.0,
                 460.0, 464.0, 464.5, 470.0, 479.0, 480.0, 500.0, 1e4,
                 -448.0, -464.0, -470.0, -1e4, np.inf, -np.inf, np.nan],
                np.float32)
# Whole-encoder embeddings, f32 (MIXED_PRECISION false), 32 segments. A
# stored value within the packages' summation error (~1e-6) of a rounding
# boundary lands on the neighbouring code in one package: a flip moves one
# activation by 1/16 (int8) or by one e4m3 step, an eighth of its value
# (fp8), and the later layers carry it on. Each segment's cosine with
# JAX's is >= EMB_COS_MIN (measured 0.9973 int8, 0.9940 fp8), and a
# segment without a flip equals JAX's to f32 rounding: at least
# EXACT_SHARE_MIN of the segments within 1e-5 (measured 31 of 32 int8).
EMB_COS_MIN = {"int8": 0.99, "fp8": 0.99}
EXACT_SHARE_MIN = {"int8": 0.75, "fp8": 0.0}
# Per layer, fed the same input: flipped codes are adjacent codes, and few.
FLIP_SHARE_MAX = 1e-3


def _inputs(dtype):
    """The same bits for both packages: EDGE and seeded random values
    spread over the int8 and fp8 ranges, in f32 or bf16."""
    rng = np.random.default_rng(7)
    x = np.concatenate([EDGE, rng.normal(0, 3, 4000).astype(np.float32),
                        rng.uniform(-600, 600, 1000).astype(np.float32),
                        (rng.integers(-300, 300, 500) / 32).astype(
                            np.float32)])
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    return (jnp.asarray(bits.view(ml_dtypes.bfloat16)),
            torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def _bits(t):
    t = t.detach()
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return (a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn
            else a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_compress_decompress_bit_equal_to_jax(mode, dtype):
    xj, xp = _inputs(dtype)
    cj = J._compress_act(xj, mode)
    cp = P._compress_act(xp, mode)
    assert cp.dtype == (torch.int8 if mode == "int8" else
                        torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bits(cp), _jbits(cj))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    pdt = torch.float32 if dtype == "f32" else torch.bfloat16
    dj = J._decompress_act(cj, mode, jdt)
    dp = P._decompress_act(cp, mode, pdt)
    assert dp.dtype == pdt
    # NaN where JAX has NaN (the codes past fp8's range): PyTorch's fp8 ->
    # bf16 cast drops a NaN's sign, which no finite activation carries
    nan = np.isnan(np.asarray(dj, np.float32))
    np.testing.assert_array_equal(np.isnan(dp.float().numpy()), nan)
    np.testing.assert_array_equal(_bits(dp)[~nan], _jbits(dj)[~nan])
    # uncompressed tensors pass through
    assert P._decompress_act(xp, mode, pdt) is xp
    if mode == "int8":
        assert int(cp.max()) == 127 and int(cp.min()) == -127
    else:   # past the range: NaN with its sign, as XLA
        v = xp.float().numpy()
        codes = _bits(cp)
        past = np.abs(v) > 464
        assert set(codes[past & (v > 0)]) == {0x7F}
        assert set(codes[past & (v < 0)]) == {0xFF}
        assert set(codes[np.abs(v) == 464]) == {0x7E, 0xFE}


def _cfg(mode, mixed=False):
    cfg = load_config("default")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=SMALL_CH,
                        MIXED_PRECISION=mixed, ACT_STORE=mode)
    return cfg


def _model(mode, mixed=False):
    m = P.get_fingerprinter(_cfg(mode, mixed), seed=3)
    with torch.no_grad():
        rng = np.random.default_rng(2)
        for t in m.state_dict().values():
            t.add_(torch.from_numpy(
                (0.1 * rng.standard_normal(t.shape)).astype(np.float32)))
    return m.eval()


def _segments(n):
    return np.random.default_rng(0).standard_normal(
        (n, 256, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_conv_layers_store_jax_codes(mode):
    """Each ConvLayer, fed the JAX layer's input, stores JAX's codes; where
    a code differs it is the neighbouring code, at most FLIP_SHARE_MAX of
    them."""
    m = _model(mode)
    variables = torch_to_flax(m.state_dict())
    x = jnp.asarray(_segments(4))
    n_codes = n_flips = 0
    for i, layer in enumerate(m.conv_layers):
        jl = J.ConvLayer(hidden_ch=layer.conv_1x3.weight.shape[0],
                         strides=J.DEFAULT_STRIDES[i], act_store=mode)
        want = jax.jit(jl.apply)(
            {"params": variables["params"][f"conv_layer_{i}"]}, x)
        xin = torch.from_numpy(np.array(
            J._decompress_act(x, mode, jnp.float32))).permute(0, 3, 1, 2)
        if i > 0:       # the stored input, as the previous layer left it
            xin = P._compress_act(xin, mode)
        with torch.no_grad():
            got = _bits(layer(xin).permute(0, 2, 3, 1).contiguous())
        w = _jbits(want)
        diff = got.astype(np.int32) - w.astype(np.int32)
        assert np.abs(diff).max() <= 1, (i, np.abs(diff).max())
        n_codes += diff.size
        n_flips += int((diff != 0).sum())
        x = want
    assert n_flips <= FLIP_SHARE_MAX * n_codes, (n_flips, n_codes)


@pytest.mark.parametrize("mode", MODES)
def test_embeddings_match_jax(mode):
    m = _model(mode)
    cfg = _cfg(mode)
    x = _segments(32)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_to_flax(m.state_dict()))
    want = np.asarray(jax.jit(J.get_fingerprinter(cfg).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    cos = (want * got).sum(1)
    assert cos.min() >= EMB_COS_MIN[mode], cos.min()
    exact = (np.abs(got - want).max(1) <= 1e-5).mean()
    assert exact >= EXACT_SHARE_MIN[mode], exact
    # and the quantisation itself is seen: not the unquantised encoder's
    plain = _model(None)
    with torch.no_grad():
        assert not np.allclose(plain(torch.from_numpy(x)).numpy(), got,
                               atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_act_store_is_inference_only(mode):
    """In training mode the encoder computes as without ACT_STORE (the
    JAX package keys it on ``train=False``); eval mode quantises."""
    x = torch.from_numpy(_segments(4))
    q, plain = _model(mode), _model(None)
    q.train()
    plain.train()
    np.testing.assert_array_equal(q(x).detach().numpy(),
                                  plain(x).detach().numpy())
    q.eval()
    plain.eval()
    with torch.no_grad():
        assert not torch.equal(q(x), plain(x))


def test_cli_generate_act_store(tmp_path, one_thread):
    """``generate --act_store int8|fp8 --nogpu`` with a port-written
    checkpoint: the memmaps have the plain run's shapes, and each
    fingerprint's cosine with the plain run's (bf16, the default
    precision) is >= 0.95: the quantisation error of this tiny random
    model (measured >= 0.9868 fp8; the JAX package's full-width fp8 on a
    TPU v5e, 0.9799)."""
    import yaml
    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.data.audio_io import load_memmap
    root = str(tmp_path)
    subprocess.run([sys.executable, os.path.join(
        REPO, "nafp_tpu_torch", "extras", "make_synth_dataset.py"), root,
        "--n_train", "0", "--n_query", "2", "--n_dummy", "1", "--sec", "4"],
        check=True, stdout=subprocess.DEVNULL)
    cfg = _cfg(None, mixed=True)
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                      BG_ROOT_DIR=f"{root}/aug/bg/",
                      IR_ROOT_DIR=f"{root}/aug/ir/",
                      OUTPUT_ROOT_DIR=f"{root}/emb/",
                      LOG_ROOT_DIR=f"{root}/logs/")
    cfg["BSZ"]["TS_BATCH_SZ"] = 8
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    save_params_npz(f"{root}/logs/checkpoint/q/1/params.npz",
                    torch_to_flax(_model(None).state_dict()))
    embs = {}
    for mode in (None, "int8", "fp8"):
        out = f"{root}/emb_{mode}"
        emb_dir = f"{out}/q/1"
        extra = ["--act_store", mode] if mode else []
        res = CliRunner().invoke(main, ["generate", "q", "1", "-c", path,
                                        "--nogpu", "--yes", "-o", out,
                                        *extra])
        assert res.exit_code == 0, res.output + repr(res.exception)
        embs[mode] = {k: np.array(load_memmap(emb_dir, k, display=False)[0])
                      for k in ("dummy_db", "db", "query")}
    for mode in MODES:
        for k, ref in embs[None].items():
            assert embs[mode][k].shape == ref.shape
            cos = (embs[mode][k] * ref).sum(1)
            assert cos.min() >= 0.95, (mode, k, cos.min())
            assert not np.array_equal(embs[mode][k], ref)


def test_bench_quant_cpu_prints_the_jax_keys(tmp_path, capsys, one_thread):
    import yaml
    from nafp_tpu_torch.extras import bench_quant
    cfg = _cfg(None, mixed=True)
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    lines = bench_quant.main(["--cpu", "--batch", "4", "--iters", "1",
                              "-c", path])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == lines
    assert [ln["act_store"] for ln in lines] == ["bf16", "int8", "fp8"]
    keys = {"act_store", "segs_per_sec", "ms_per_batch"}
    assert keys <= set(lines[0]) and lines[0]["device"] == "cpu"
    for ln in lines[1:]:
        assert keys | {"cos_vs_bf16_min", "cos_vs_bf16_mean"} <= set(ln)
        assert 0.9 <= ln["cos_vs_bf16_min"] <= ln["cos_vs_bf16_mean"] <= 1.0
