"""Work counts from shapes: operations and bytes of the function, not of
one implementation of it.

``segment_flops`` is the benchmark's frozen copy of the port's
``bench.flops_per_call`` arithmetic, taken from the configuration instead
of from the port's model object: 2 FLOPs per multiply-add of the framed
DFT (frames x n_fft x 2K) and of the mel filterbank (frames x K x mels),
of every convolution (output positions x input channels x kernel cells)
and of DivEnc's two einsums.
"""
from __future__ import annotations

from typing import Any, Dict

from portbench.reference import arch


def logmel_flops(m: Dict[str, Any]) -> float:
    n_fft, n_mels = int(m["STFT_WIN"]), int(m["N_MELS"])
    n_freq = n_fft // 2 + 1
    macs = arch.n_frames(m) * (n_fft * 2 * n_freq + n_freq * n_mels)
    return 2.0 * macs


def encoder_flops(m: Dict[str, Any]) -> float:
    macs = 0
    for c in arch.convs(m):
        macs += (c.c_out * c.out_hw[0] * c.out_hw[1] * c.c_in
                 * c.kernel[0] * c.kernel[1])
    q = int(m["EMB_SZ"])
    u0, u1 = (int(u) for u in m["FC_UNIT_DIM"])
    s = arch.flat_dim(m) // q
    macs += q * s * u0 + q * u0 * u1
    return 2.0 * macs


def segment_flops(m: Dict[str, Any]) -> float:
    """One segment through log-mel and the encoder (inference)."""
    return logmel_flops(m) + encoder_flops(m)


def train_segment_flops(m: Dict[str, Any]) -> float:
    """One segment of a train step, by the convention of ``train.mfu``:
    the encoder's forward once and its backward as twice the forward (the
    products for the input's and for the weights' gradients), and the
    log-mel's forward once, since no gradient flows into the waveform."""
    return 3.0 * encoder_flops(m) + logmel_flops(m)


def topk_f32_least_seconds(bq: int, n: int, d: int, k: int,
                           flops_peak: float, bytes_peak: float) -> float:
    """Least time of an exact f32 top-k of (bq, d) queries over (n, d)
    rows: the larger of the useful products (2·bq·n·d at the dense TF32
    peak) and every input and output byte once (queries, rows, k scores
    and k int32 ids a query) at the memory bandwidth."""
    flops = 2.0 * bq * n * d
    nbytes = 4.0 * (bq * d + n * d) + 8.0 * bq * k
    return max(flops / flops_peak, nbytes / bytes_peak)


def search_flops(n_query_segments: int, n: int, d: int) -> float:
    """Useful products of an exact search: 2·N·d for each query segment."""
    return 2.0 * n_query_segments * n * d


def rerank_flops(b: int, sl: int, k_probe: int, d: int) -> float:
    """Products of the sequence re-rank of one block: 2·d for each window
    row scored, b queries x (sl·k_probe) candidates x sl rows."""
    return 2.0 * d * b * (sl * k_probe) * sl
