"""Device-resident audio corpus: upload the songs once, gather per step.

Counterpart of ``nafp_tpu/data/device_corpus.py``. The host loader
(``data/loader.py``) decodes and uploads raw waveform batches every step:
O(batch x T) bytes over PCIe. For a corpus that fits device memory the
decoded songs go up ONCE as int16 PCM, and each batch then ships only
int64 flat offsets (row·L + start): O(batch) bytes, and the segments are
cut out on the card at HBM bandwidth.

Exactness: WAV PCM is int16 and both host decoders scale by 1/32768
(``native/wavio.cc``, ``data/audio_io.py``), so the card's
``int16 * (1/32768)`` reproduces the host loader's float32 samples bit for
bit (every i/32768 with |i| <= 32768 is a float32). The wrapped loader's
:meth:`~SegmentLoader.plan_batch` supplies every offset, shuffle and
augmentation pairing, so both paths consume one RNG stream in one order
and give identical batches (``tests/test_torch_device_corpus.py``).

Streams: :func:`~nafp_tpu_torch.data.loader.prefetch` calls
``__getitem__`` on its worker thread, so the gathers are launched from
that thread. Every thread's current stream is the device's default stream
unless a caller selects another, and neither the trainer nor ``generate``
does: a step enqueued after a batch was handed over runs after its
gathers. A consumer on another stream must wait on the default stream.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nafp_tpu_torch.data.audio_io import load_wav_segment, wav_info
from nafp_tpu_torch.data.loader import MAX_IR_LENGTH, SegmentLoader
from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.native import load_segments_native

PCM_SCALE = np.float32(1.0 / 32768.0)   # both host decoders' scale


def corpus_nbytes(paths: Sequence[str], pad_to: int = 128) -> int:
    """Device bytes of a :class:`DeviceCorpus` over ``paths`` (int16, every
    song padded to the longest), from the WAV headers alone: the budget
    gate runs before anything is decoded."""
    if not paths:
        return 0
    longest = max(wav_info(p)[0] for p in paths)
    longest += (-longest) % pad_to
    return 2 * longest * len(paths)


class DeviceCorpus:
    """Decoded songs on the device as one (n_songs, L) int16 tensor.

    ``L`` is the longest song rounded up to ``pad_to`` frames (at least
    ``min_len``); shorter songs are zero-padded, as the host loader
    zero-pads reads past the end of a file.
    """

    def __init__(self, paths: Sequence[str], fs: int = 8000,
                 decoder_threads: int = 4, pad_to: int = 128,
                 min_len: int = 0, device: DeviceLike = None):
        if not paths:
            raise ValueError("empty corpus")
        self.paths = list(paths)
        self.row = {p: i for i, p in enumerate(self.paths)}
        self.fs = int(fs)
        longest = max(max(wav_info(p)[0] for p in self.paths), min_len)
        self.length = longest + (-longest) % pad_to
        n = len(self.paths)
        device = resolve_device(device)
        pcm = torch.zeros((n, self.length), dtype=torch.int16,
                          pin_memory=device.type == "cuda")
        pcm_np = pcm.numpy()
        blk = 64
        for s in range(0, n, blk):
            e = min(s + blk, n)
            out = load_segments_native(self.paths[s:e], [0] * (e - s),
                                       self.length, decoder_threads)
            if out is None:
                out = np.stack([load_wav_segment(p, 0, self.length, fs)
                                for p in self.paths[s:e]])
            np.multiply(out, 32768.0, out=out)  # exact: values are i/32768
            pcm_np[s:e] = out                   # exact-integral f32 -> int16
        self.data = pcm.to(device)              # (n, L) int16, one upload

    def rows_of(self, paths: Sequence[str]) -> np.ndarray:
        return np.fromiter((self.row[p] for p in paths), np.int64,
                           count=len(paths))


def gather_segments(corpus: torch.Tensor, offsets: torch.Tensor,
                    n_valid: int, seg_len: int) -> torch.Tensor:
    """(len(offsets), seg_len) float32 segments cut from the resident
    corpus at the flat sample offsets ``row·L + start``; rows at index >=
    ``n_valid`` are zero (the host loader's padding)."""
    flat = corpus.view(-1)
    idx = offsets[:, None] + torch.arange(seg_len, device=corpus.device)
    seg = flat[idx].to(torch.float32) * PCM_SCALE
    if n_valid < len(offsets):
        seg[n_valid:] = 0.0
    return seg


class DeviceGatherLoader:
    """A :class:`SegmentLoader` whose batches are gathered on the device.

    ``__getitem__`` keeps the host loader's dict contract
    ('anchors'/'replicas'/'bg'/'ir'/'speech' + a host-side 'n_valid'),
    with the waveforms as float32 tensors on the corpus's device. Every
    other attribute is the wrapped loader's.
    """

    def __init__(self, base: SegmentLoader, decoder_threads: int = 4,
                 device: DeviceLike = None):
        self.base = base
        device = resolve_device(device)
        self.device = device

        def corpus(seg_list, min_len):
            return DeviceCorpus(sorted({f for f, *_ in seg_list}), base.fs,
                                decoder_threads, min_len=min_len,
                                device=device)
        self._ev = corpus(base.fns_event_seg_list, base.seg_len)
        self._bg = corpus(base.bg_seg_list, base.seg_len) \
            if base.bg_mix else None
        self._ir = corpus(base.ir_seg_list, MAX_IR_LENGTH) \
            if base.ir_mix else None
        self._speech = corpus(base.speech_seg_list, base.seg_len) \
            if base.speech_mix else None
        # zero stand-ins, made once: the query-synthesis loader has no
        # anchors, an anchors-only loader no replicas
        self._no_anchors = torch.zeros((base.n_anchor, base.seg_len),
                                       device=device)
        self._no_replicas = torch.zeros((0, base.seg_len), device=device)

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __len__(self) -> int:
        return len(self.base)

    def _offsets(self, corpus: DeviceCorpus, paths, starts, pad_rows: int,
                 want_len: int) -> torch.Tensor:
        starts = np.asarray(starts, np.int64)
        # A start past the padded row end would read into the NEXT song
        # (the gather is flat); the planner keeps reads inside the row, so
        # a violation is a fault: fail loud.
        if len(starts) and int(starts.max()) + want_len > corpus.length:
            raise ValueError("segment read past padded song end")
        off = np.zeros(pad_rows, np.int64)
        off[:len(starts)] = corpus.rows_of(paths) * corpus.length + starts
        off = torch.from_numpy(off)
        if self.device.type != "cuda":
            return off
        # a pageable copy would wait for the stream to drain, so the
        # prefetch thread could not run ahead of the step; a block of the
        # caching pinned allocator is reused only after its copy is done
        return off.pin_memory().to(self.device, non_blocking=True)

    def _gather(self, corpus: DeviceCorpus, plan_item, pad_rows: int,
                n_valid: int, seg_len: int) -> torch.Tensor:
        paths, starts = plan_item
        off = self._offsets(corpus, paths, starts, pad_rows, seg_len)
        return gather_segments(corpus.data, off, n_valid, seg_len)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        b = self.base
        plan = b.plan_batch(idx)
        n_valid = plan["n_valid"]
        out: Dict[str, object] = {"n_valid": np.int32(n_valid)}
        out["anchors"] = (self._no_anchors if b.reduce_batch_first_half
                          else self._gather(self._ev, plan["anchors"],
                                            b.n_anchor, n_valid, b.seg_len))
        n_rep = len(plan["replicas"][0])
        out["replicas"] = (self._gather(self._ev, plan["replicas"],
                                        b.n_pos_bsz, n_rep, b.seg_len)
                           if b.n_pos_bsz else self._no_replicas)
        for key, corpus, seg_len in (("bg", self._bg, b.seg_len),
                                     ("ir", self._ir, MAX_IR_LENGTH),
                                     ("speech", self._speech, b.seg_len)):
            if corpus is not None:
                out[key] = self._gather(corpus, plan[key], b.n_pos_bsz,
                                        len(plan[key][0]), seg_len)
        return out


def maybe_device_loader(loader: SegmentLoader, cfg: Dict,
                        decoder_threads: int = 4, label: str = "",
                        device: DeviceLike = None) -> object:
    """``loader`` wrapped in a :class:`DeviceGatherLoader` when
    ``DEVICE.DEVICE_CORPUS`` is on and its songs fit the
    ``DEVICE.DEVICE_CORPUS_MAX_GB`` budget (default 4 GiB); otherwise
    ``loader`` itself, with a note when the budget turned it away."""
    dev_cfg = cfg.get("DEVICE", {})
    if not dev_cfg.get("DEVICE_CORPUS"):
        return loader
    budget = float(dev_cfg.get("DEVICE_CORPUS_MAX_GB", 4.0)) * 2 ** 30
    paths = sorted({f for f, *_ in loader.fns_event_seg_list})
    est = corpus_nbytes(paths)
    if est > budget:
        print(f"[device_corpus] {label or 'corpus'} est {est / 2**30:.2f} "
              f"GiB exceeds DEVICE_CORPUS_MAX_GB — using the host loader",
              flush=True)
        return loader
    wrapped = DeviceGatherLoader(loader, decoder_threads, device=device)
    print(f"[device_corpus] {label or 'corpus'}: {len(paths)} songs "
          f"resident ({est / 2**30:.2f} GiB int16)", flush=True)
    return wrapped

