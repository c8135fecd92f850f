"""Port parity: the port's own copies of two JAX-side tools, on the CPU.

- ``nafp_tpu_torch/utils/plotter.py::get_imshow_image``: the same RGBA
  array as ``nafp_tpu/utils/plotter.py`` for the same matrix (matplotlib
  draws both);
- ``nafp_tpu_torch/extras/make_synth_dataset.py``: the same files, byte for
  byte, as ``extras/make_synth_dataset.py`` at a tiny size, run as the
  port runs it (a subprocess of its path, and ``python -m``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("title", [None, "tr_sim_mtx"])
def test_imshow_image_matches_jax(title):
    from nafp_tpu.utils.plotter import get_imshow_image as jax_image
    from nafp_tpu_torch.utils.plotter import get_imshow_image
    m = np.random.default_rng(3).standard_normal((24, 120)).astype(
        np.float32)
    got = get_imshow_image(m, title=title)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 4
    np.testing.assert_array_equal(got, jax_image(m, title=title))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("how", ["path", "module"])
def test_make_synth_dataset_is_the_jax_bytes(tmp_path, how):
    args = ["--n_train", "2", "--n_query", "2", "--n_dummy", "2", "--sec",
            "1"]
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    subprocess.run([sys.executable, os.path.join(
        REPO, "extras", "make_synth_dataset.py"), jax_root] + args,
        check=True, stdout=subprocess.DEVNULL)
    port = ([os.path.join(REPO, "nafp_tpu_torch", "extras",
                          "make_synth_dataset.py")] if how == "path" else
            ["-m", "nafp_tpu_torch.extras.make_synth_dataset"])
    subprocess.run([sys.executable] + port + [port_root] + args, check=True,
                   stdout=subprocess.DEVNULL, cwd=REPO)
    want, got = _files(jax_root), _files(port_root)
    # 2 train, 8 val, 2 db, 2 query, 2 dummy songs; 6 bg, 6 ir and 6
    # speech files per split (tr/ts); 4 speech dev files
    assert len(want) == 2 + 8 + 2 + 2 + 2 + 2 * 18 + 4
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


@pytest.mark.parametrize("entry", ["bench_quant", "dataset2wav"])
def test_new_entry_points_need_a_card(tmp_path, entry):
    """Without ``--cpu`` the slice's new entry points run on cuda:0, and
    on a machine without a card they stop with "no CUDA device"."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    if entry == "bench_quant":
        from nafp_tpu_torch.extras.bench_quant import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    else:
        from click.testing import CliRunner
        from nafp_tpu_torch.extras.dataset2wav import main
        res = CliRunner().invoke(main, [str(tmp_path / "out")])
        assert isinstance(res.exception, RuntimeError)
        assert "no CUDA device" in str(res.exception)
        assert not os.path.exists(tmp_path / "out")
