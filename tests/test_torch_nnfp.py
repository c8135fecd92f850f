"""Port parity: FingerPrinter + flax_to_torch against the JAX package's
encoder (f32, MIXED_PRECISION false, both on the CPU), the converter's
coverage at full width, and parameter counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.models import nnfp as jnnfp
from nafp_tpu_torch.models import nnfp as tnnfp
from nafp_tpu_torch.models.convert import (flatten, flax_to_torch,
                                           load_params_npz, save_params_npz)

SMALL_CH = (16, 16, 32, 32, 32, 32, 64, 64)
EMB = 32
# f32 on both sides; sums run in other orders (XLA vs PyTorch convolutions
# and einsums), measured differences ~1e-6 on unit-norm embeddings.
ATOL = 2e-5


def _jax_variables(norm, t_frames, seed=1):
    """Flax variables, perturbed from init so every parameter matters
    (batch_norm: non-trivial running statistics)."""
    model = jnnfp.FingerPrinter(emb_sz=EMB, front_hidden_ch=SMALL_CH,
                                norm=norm)
    x = jnp.zeros((1, 256, t_frames, 1), jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), v)
    if "batch_stats" in v:
        v = dict(v)
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return model, v


@pytest.mark.parametrize("norm,t_frames", [
    ("layer_norm2d", 32),
    ("layer_norm2d", 33),   # odd time length: asymmetric 'SAME' padding
    ("layer_norm1d", 32),
    ("batch_norm", 32),
    ("batch_norm", 33),
])
def test_fingerprinter_matches_jax(norm, t_frames):
    model, v = _jax_variables(norm, t_frames)
    x = np.random.default_rng(2).standard_normal(
        (3, 256, t_frames, 1)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    tm = tnnfp.FingerPrinter((256, t_frames), emb_sz=EMB,
                             front_hidden_ch=SMALL_CH, norm=norm)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, EMB)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_same_padding_matches_flax_rule():
    """Stride-2 'SAME' padding: total max((ceil(n/s)-1)*s + k - n, 0), the
    odd cell at the end."""
    assert tnnfp._same_pad(32, 3, 2) == (0, 1)
    assert tnnfp._same_pad(33, 3, 2) == (1, 1)
    assert tnnfp._same_pad(256, 3, 2) == (0, 1)
    assert tnnfp._same_pad(5, 3, 1) == (1, 1)
    assert tnnfp._same_pad(7, 1, 1) == (0, 0)


@pytest.mark.parametrize("t_frames,count", [(32, 16_939_008),
                                            (63, 19_224_576)])
def test_param_count_full_width(t_frames, count):
    m = tnnfp.FingerPrinter((256, t_frames))
    assert sum(p.numel() for p in m.parameters()) == count


@pytest.mark.parametrize("norm", ["layer_norm2d", "batch_norm"])
def test_converter_covers_full_width(norm):
    """Every state_dict entry of the full-width port is produced, with its
    shape, from the Flax tree (shapes via eval_shape: JAX computes
    nothing)."""
    model = jnnfp.FingerPrinter(norm=norm)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 32, 1), jnp.float32))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_torch(zeros)
    want = tnnfp.FingerPrinter((256, 32), norm=norm).state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert tuple(sd[k].shape) == tuple(t.shape), k


def test_params_npz_roundtrip(tmp_path):
    _, v = _jax_variables("batch_norm", 32)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, v)
    back = load_params_npz(path)
    assert set(flatten(back)) == set(flatten(v))
    for k, a in flatten(v).items():
        np.testing.assert_array_equal(flatten(back)[k], a)
    assert "params/conv_layer_0/conv_1x3/kernel" in flatten(back)


def test_get_fingerprinter_from_cfg():
    from nafp_tpu_torch.configuration import load_config
    cfg = load_config("default")
    cfg["MODEL"].update(EMB_SZ=EMB, FRONT_HIDDEN_CH=list(SMALL_CH))
    m = tnnfp.get_fingerprinter(cfg)
    assert m.dtype == torch.bfloat16          # MIXED_PRECISION default
    cfg["MODEL"]["ACT_STORE"] = "int8"
    with pytest.raises(NotImplementedError, match="ACT_STORE"):
        tnnfp.get_fingerprinter(cfg)


def test_l2_normalize_semantics():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(tnnfp.l2_normalize(x).numpy(),
                               np.asarray(jnnfp.l2_normalize(
                                   jnp.asarray(x.numpy()))), atol=1e-7)


def test_bf16_conv_on_cpu_is_f32_sum_of_bf16_operands():
    """On the CPU a bf16 SameConv2d equals the f32 convolution of its bf16
    operands rounded once to bf16 (PyTorch's own CPU bf16 conv returns
    wrong values at this layer-5 shape of the full-width encoder)."""
    conv = tnnfp.SameConv2d(512, 512, (1, 3), (1, 2), (8, 2))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 512, 8, 2)).astype(np.float32)).to(torch.bfloat16)
    got = conv(x)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 512, 8, 1)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.float(), conv.pad),
        conv.weight.to(torch.bfloat16).float(),
        conv.bias.to(torch.bfloat16).float(), stride=(1, 2)).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_bf16_compute_close_to_f32():
    """Mixed precision keeps the embedding's direction (the JAX package's
    test_bfloat16_compute_close_to_f32 floor, cos > 0.98)."""
    _, v = _jax_variables("layer_norm2d", 32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 256, 32, 1)).astype(np.float32))
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        m = tnnfp.FingerPrinter((256, 32), emb_sz=EMB,
                                front_hidden_ch=SMALL_CH, dtype=dt)
        m.load_state_dict(flax_to_torch(v))
        with torch.no_grad():
            outs.append(m.eval()(x))
    assert outs[1].dtype == torch.float32
    assert float((outs[0] * outs[1]).sum(1).min()) > 0.98
