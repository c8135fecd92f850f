"""The port's device helpers (``nafp_tpu_torch/device.py``):
``chunked_device_put`` against ``torch.from_numpy`` of the same memmap, the
exact-index row norms it feeds, and ``device_memory_stats``'s CPU form.
Every comparison is exact (a copy, and the same einsum per row)."""
import functools

import numpy as np
import pytest
import torch

from nafp_tpu_torch import device as D
from nafp_tpu_torch.search import index as PI

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def memmap_rows(tmp_path_factory):
    a = np.random.default_rng(3).standard_normal((1001, 7)).astype(
        np.float32)
    path = str(tmp_path_factory.mktemp("mm") / "rows.mm")
    a.tofile(path)
    return np.memmap(path, np.float32, "r", shape=a.shape)


# row chunks of 143 rows (divides 1001), 10, 1 and 1001 rows, and all
# rows in one chunk
@pytest.mark.parametrize("rows", [143, 10, 1, 1001, 4096])
def test_chunked_put_equals_from_numpy(memmap_rows, rows):
    seen = []
    out = D.chunked_device_put(memmap_rows, CPU, chunk_bytes=28 * rows,
                               visit=lambda s, blk: seen.append(
                                   (s, len(blk))))
    assert out.dtype == torch.float32 and out.device == CPU
    assert torch.equal(out, torch.from_numpy(np.array(memmap_rows)))
    starts = [s for s, _ in seen]
    assert starts == sorted(starts) and starts[0] == 0
    assert sum(n for _, n in seen) == len(memmap_rows)
    assert all(n == min(rows, 1001) for _, n in seen[:-1])


def test_chunked_put_converts_and_takes_1d():
    x = np.arange(1000, dtype=np.float64) / 7
    out = D.chunked_device_put(x, CPU, np.float32, chunk_bytes=400)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.from_numpy(x.astype(np.float32)))
    ids = np.arange(-3, 997, dtype=np.int64)
    assert torch.equal(D.chunked_device_put(ids, CPU, np.int32,
                                            chunk_bytes=64),
                       torch.from_numpy(ids.astype(np.int32)))
    empty = D.chunked_device_put(np.zeros((0, 5), np.int8), CPU)
    assert empty.shape == (0, 5) and empty.dtype == torch.int8


def test_flat_index_norms_equal_one_einsum(memmap_rows, monkeypatch):
    """FlatIndex computes its row norms one staged chunk at a time; they
    equal the whole-array einsum bit for bit, so l2 distances do not
    move."""
    monkeypatch.setattr(PI, "chunked_device_put", functools.partial(
        D.chunked_device_put, chunk_bytes=28 * 100))
    idx = PI.FlatIndex(memmap_rows, metric="l2", device=CPU)
    full = np.ascontiguousarray(memmap_rows, np.float32)
    np.testing.assert_array_equal(idx._db_sq_host,
                                  np.einsum("nd,nd->n", full, full))
    assert torch.equal(idx.db, torch.from_numpy(full))


def test_device_memory_stats_cpu_form():
    (rec,) = D.device_memory_stats(CPU)
    assert rec == {"id": 0, "platform": "cpu", "kind": "cpu",
                   "bytes_in_use": None, "peak_bytes_in_use": None,
                   "bytes_limit": None}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert D.chunked_device_put(np.zeros((4, 4), np.float32)).is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.chunked_device_put(np.zeros((4, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.device_memory_stats()
