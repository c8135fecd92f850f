"""The port's headline benchmark (``nafp_tpu_torch/bench.py``) on the CPU:
its JSON line, and its FLOP count held against a hand count of the
multiply-adds (exactly) and against XLA's ``cost_analysis`` of the JAX
package's fingerprint function (XLA also counts the elementwise work:
measured 1.012x the port's count in f32 and 1.022x in bf16 at this plan,
so it must lie in [1.0, 1.05] of it)."""
import json
import math

import jax
import jax.numpy as jnp
import pytest
import yaml

from nafp_tpu.configuration import load_config as jax_load_config
from nafp_tpu_torch import bench as PB
from nafp_tpu_torch.configuration import load_config
from nafp_tpu_torch.models.nnfp import DEFAULT_STRIDES, get_fingerprinter
from nafp_tpu_torch.ops.melspec import get_melspec_fn

CHANNELS = [8, 8, 16, 16, 16, 16, 32, 32]
EMB = 32
XLA_RATIO = (1.0, 1.05)


def _cfg(loader, mixed):
    cfg = loader("default")
    cfg["MODEL"].update(EMB_SZ=EMB, FRONT_HIDDEN_CH=CHANNELS,
                        MIXED_PRECISION=mixed)
    return cfg


def _hand_count(batch):
    """Multiply-adds of one call from the channel plan, by hand: 1 s at
    8 kHz, hop 256 -> 32 frames of 1024 samples; a 513-bin DFT as 1026
    columns; 256 mels; each SAME convolution keeps ceil(size / stride)."""
    macs = 32 * (1024 * 1026 + 513 * 256)
    h, w, c_in = 256, 32, 1
    for c, ((sh1, sw1), (sh2, sw2)) in zip(CHANNELS, DEFAULT_STRIDES):
        h, w = math.ceil(h / sh1), math.ceil(w / sw1)
        macs += h * w * c * c_in * 3                 # conv 1x3
        h, w = math.ceil(h / sh2), math.ceil(w / sw2)
        macs += h * w * c * c * 3                    # conv 3x1
        c_in = c
    flat = h * w * c_in
    macs += EMB * (flat // EMB) * 32 + EMB * 32 * 1  # DivEnc
    return 2 * batch * macs


def test_flops_equal_the_hand_count():
    cfg = _cfg(load_config, False)
    _, mcfg = get_melspec_fn(cfg)
    assert PB.flops_per_call(get_fingerprinter(cfg), mcfg, 4) \
        == _hand_count(4)


@pytest.mark.parametrize("mixed", [False, True])
def test_flops_near_xla_cost_analysis(mixed):
    from nafp_tpu.models.nnfp import get_fingerprinter as jax_fp
    from nafp_tpu.ops.melspec import get_melspec_fn as jax_melspec
    cfg = _cfg(jax_load_config, mixed)
    melspec_fn, mcfg = jax_melspec(cfg)
    model = jax_fp(cfg)
    x = jnp.zeros((4, mcfg.n_samples), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), melspec_fn(x))
    fingerprint = jax.jit(lambda p, x: model.apply(p, melspec_fn(x),
                                                   train=False))
    cost = fingerprint.lower(params, x).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    pcfg = _cfg(load_config, mixed)
    _, pmcfg = get_melspec_fn(pcfg)
    ours = PB.flops_per_call(get_fingerprinter(pcfg), pmcfg, 4)
    ratio = float(cost["flops"]) / ours
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1], ratio


def test_main_prints_one_line_with_the_jax_keys(tmp_path, capsys):
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_cfg(load_config, False), f)
    line = PB.main(["--cpu", "--batch", "4", "--iters", "2", "-c", path])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed == [line]
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["metric"] == "fingerprint_throughput" and line["value"] > 0
    assert line["unit"] == "segments/sec/chip"
    assert line["vs_baseline"] == round(line["value"] / 10_000.0, 3)
    assert line["device"] == "cpu" and line["batch"] == 4
    assert line["gflop_per_call"] == round(_hand_count(4) / 1e9, 3)
    # a CPU run prints no device rate and no mfu
    assert "mfu" not in line and "tflops" not in line
