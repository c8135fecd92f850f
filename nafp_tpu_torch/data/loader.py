"""Host batch loader: raw waveforms only — augmentation happens on-device.

Counterpart of the reference's ``genUnbalSequence``
(``model/utils/dataloader_keras.py:11-482``) with one architectural change:
the reference's worker processes decode audio *and* run all mixing math on
the CPU (its throughput bottleneck); here ``__getitem__`` returns the
clean anchor/replica waveforms plus the raw bg/IR source segments, and the
device-side time-domain augmentation mixes them (ported with training).
This slice uses the plain test loaders: anchors only, zero-padded static
batches with ``n_valid``.

Preserved semantics:
  - anchor offsets uniform in [max(off_min, -margin), min(off_max, margin)]
    with margin = hop * offset_margin_hop_rate * fs (dataloader:96-98,
    321-334);
  - replica offsets uniform within ±margin of the anchor offset, clamped to
    the segment's legal range (:339-378);
  - bg/ir selection by batch-position modulo shuffled source lists
    (:231-299), bg offset random in [0, dur/2] capped by the source segment
    residual (:401-426), IR from segment 0 only (:164-167);
  - n_anchor == bsz -> anchors only, no augmentation sources (test/dummy
    loaders, dataset.py:204-214);
  - ``reduce_batch_first_half`` -> replicas only (query synthesis, :308-309);
  - drop-last only for training (:130-136).

Deliberate deviation: the reference seeds numpy *per segment index*
(:328) so every epoch replays identical anchor offsets; here randomness is
keyed by (seed, epoch, batch) — reproducible run-to-run, fresh per epoch.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from typing import Dict, Sequence

import numpy as np

from nafp_tpu_torch.data.audio_io import load_wav_segment, wav_info
from nafp_tpu_torch.native import load_segments_native
from nafp_tpu_torch.utils.profiling import count, span

# Longest impulse response the time-domain augmentation convolves with
# (the JAX package keeps it in ops/tdaug.py; a test holds the two equal).
MAX_IR_LENGTH = 600


class SongCache:
    """Bounded FIFO cache of fully-decoded waveforms.

    The fingerprint workload reads every song ~59 times per epoch (one per
    segment, plus replicas); decoding each file once and slicing from RAM
    removes the host decode bottleneck entirely (decoded Dataset-mini is
    ~10 GB against 125 GB host RAM). Single-consumer (the prefetch thread).
    """

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self._store: "dict[str, np.ndarray]" = {}
        self._bytes = 0

    def get(self, path: str, fs: int) -> np.ndarray:
        arr = self._store.get(path)
        if arr is None:
            n_frames, _ = wav_info(path)
            out = load_segments_native([path], [0], n_frames)
            arr = out[0] if out is not None \
                else load_wav_segment(path, 0, n_frames, fs)
            self._store[path] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.capacity and len(self._store) > 1:
                k, v = next(iter(self._store.items()))
                if k == path:
                    break
                del self._store[k]
                self._bytes -= v.nbytes
        return arr

    def slice(self, path: str, start: int, length: int, fs: int) -> np.ndarray:
        arr = self.get(path, fs)
        out = np.zeros(length, np.float32)
        s = max(0, min(start, len(arr)))
        e = min(s + length, len(arr))
        out[:e - s] = arr[s:e]
        return out


class SegmentLoader:
    def __init__(self,
                 fns_event_list: Sequence[str],
                 bsz: int = 120,
                 n_anchor: int = 60,
                 duration: float = 1.0,
                 hop: float = 0.5,
                 fs: int = 8000,
                 shuffle: bool = False,
                 seg_mode: str = "all",
                 random_offset_anchor: bool = False,
                 offset_margin_hop_rate: float = 0.4,
                 bg_fps: Sequence[str] = (),
                 ir_fps: Sequence[str] = (),
                 speech_fps: Sequence[str] = (),
                 reduce_items_p: int = 0,
                 reduce_batch_first_half: bool = False,
                 experimental_mode: bool = False,
                 drop_the_last_non_full_batch: bool = True,
                 seed: int = 0,
                 use_native_decoder: bool = True,
                 decoder_threads: int = 4,
                 song_cache_bytes: int = 0):
        from nafp_tpu_torch.data.catalog import build_seg_list  # circular-safe

        self.bsz, self.n_anchor = int(bsz), int(n_anchor)
        if self.bsz != self.n_anchor:
            self.n_pos_per_anchor = round((bsz - n_anchor) / n_anchor)
            self.n_pos_bsz = bsz - n_anchor
        else:
            self.n_pos_per_anchor = 0
            self.n_pos_bsz = 0
        self.duration, self.hop, self.fs = float(duration), float(hop), int(fs)
        self.seg_len = int(fs * duration)
        self.shuffle = bool(shuffle)
        self.random_offset_anchor = bool(random_offset_anchor)
        self.offset_margin_frame = int(hop * offset_margin_hop_rate * fs)
        self.reduce_batch_first_half = reduce_batch_first_half
        # experimental_mode: fixed, evenly spread replica offsets instead of
        # random ones (reference dataloader_keras.py:179-183,348-358); used
        # by the offline query-synthesis tool (extras/dataset2wav.py).
        self.experimental_mode = experimental_mode
        if experimental_mode and self.n_pos_per_anchor > 0:
            self.experimental_offsets_sec = (
                (np.arange(self.n_pos_per_anchor)
                 - (self.n_pos_per_anchor - 1) / 2)
                / self.n_pos_per_anchor) * hop
        self.seed = seed
        self.epoch = 0
        self.use_native_decoder = use_native_decoder
        self.decoder_threads = decoder_threads
        self.cache = SongCache(song_cache_bytes) if song_cache_bytes else None

        self.fns_event_seg_list = build_seg_list(list(fns_event_list),
                                                 seg_mode, fs, duration, hop)
        assert reduce_items_p <= 100
        self.reduce_items_p = reduce_items_p

        if drop_the_last_non_full_batch:  # training
            self.n_samples = (len(self.fns_event_seg_list) // self.n_anchor
                              ) * self.n_anchor
        else:
            self.n_samples = len(self.fns_event_seg_list)
        if self.n_samples == 0:
            raise ValueError("empty dataset (no segments found)")

        self.bg_mix = bool(bg_fps) and self.n_pos_bsz > 0
        self.ir_mix = bool(ir_fps) and self.n_pos_bsz > 0
        self.speech_mix = bool(speech_fps) and self.n_pos_bsz > 0
        self.bg_seg_list = build_seg_list(list(bg_fps), "all", fs, duration) \
            if self.bg_mix else []
        self.ir_seg_list = build_seg_list(list(ir_fps), "first", fs, duration) \
            if self.ir_mix else []
        self.speech_seg_list = build_seg_list(list(speech_fps), "all", fs,
                                              duration) \
            if self.speech_mix else []

        self._reshuffle()

    # ------------------------------------------------------------------
    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, idx))

    def _reshuffle(self):
        rng = np.random.default_rng((self.seed, self.epoch, 0xEA0C))
        self.index_event = (rng.permutation(self.n_samples) if self.shuffle
                            else np.arange(self.n_samples))
        if self.bg_mix:
            n = len(self.bg_seg_list)
            self.index_bg = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.ir_mix:
            n = len(self.ir_seg_list)
            self.index_ir = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.speech_mix:
            n = len(self.speech_seg_list)
            self.index_speech = (rng.permutation(n) if self.shuffle
                                 else np.arange(n))

    def set_epoch(self, epoch: int):
        """Re-shuffle for a new epoch (reference on_epoch_end, :196-220)."""
        self.epoch = int(epoch)
        self._reshuffle()

    def __len__(self) -> int:
        n = math.ceil(self.n_samples / self.n_anchor)
        if self.reduce_items_p:
            return int(n * self.reduce_items_p / 100)
        return n

    # ------------------------------------------------------------------
    def plan_batch(self, idx: int) -> Dict[str, object]:
        """Plan every (path, start_frame) read of batch ``idx`` without
        decoding any audio.

        Used by the host decode path (:meth:`__getitem__`); one RNG
        stream in one order, so the plan is reproducible.

        Returns ``{'anchors': (paths, starts), 'replicas': (paths, starts),
        'bg': ..., 'ir': ..., 'speech': ..., 'n_valid': int}`` with aug
        keys present only when that source is mixed in.
        """
        if idx >= len(self):
            raise IndexError(idx)
        rng = self._rng(idx)
        sel = self.index_event[idx * self.n_anchor:(idx + 1) * self.n_anchor]
        n_valid = len(sel)

        a_paths, a_starts = [], []
        p_paths, p_starts = [], []
        for ev in sel:
            fname, seg_idx, off_min, off_max = self.fns_event_seg_list[ev]
            a_lo = max(off_min, -self.offset_margin_frame)
            a_hi = min(off_max, self.offset_margin_frame)
            if (self.random_offset_anchor and not self.experimental_mode
                    and a_hi > a_lo):
                a_off = int(rng.integers(a_lo, a_hi))
            else:
                a_off = 0
            base = int(seg_idx * self.hop * self.fs)
            a_paths.append(fname)
            a_starts.append(base + a_off)
            if self.n_pos_per_anchor > 0:
                p_lo = max(a_off - self.offset_margin_frame, off_min)
                p_hi = min(a_off + self.offset_margin_frame, off_max)
                for j in range(self.n_pos_per_anchor):
                    if self.experimental_mode:
                        sec = float(np.clip(self.experimental_offsets_sec[j],
                                            p_lo / self.fs, p_hi / self.fs))
                        p_off = int(sec * self.fs)
                    elif p_hi > p_lo:
                        p_off = int(rng.integers(p_lo, p_hi))
                    else:
                        p_off = 0
                    p_paths.append(fname)
                    p_starts.append(base + p_off)

        plan: Dict[str, object] = {"anchors": (a_paths, a_starts),
                                   "replicas": (p_paths, p_starts),
                                   "n_valid": n_valid}
        if self.bg_mix:
            plan["bg"] = self._plan_sources(
                idx, rng, self.bg_seg_list, self.index_bg, random_offset=True)
        if self.ir_mix:
            plan["ir"] = self._plan_sources(
                idx, rng, self.ir_seg_list, self.index_ir,
                random_offset=False)
        if self.speech_mix:
            plan["speech"] = self._plan_sources(
                idx, rng, self.speech_seg_list, self.index_speech,
                random_offset=True)
        return plan

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """Returns a dict of static-shaped float32 arrays:

        'anchors'  (n_anchor, T)  zero-padded past n_valid
        'replicas' (n_pos,   T)   clean replica waveforms (offset only)
        'bg'       (n_pos,   T)   raw background segments (if bg aug)
        'ir'       (n_pos, 600)   raw impulse responses (if ir aug)
        'n_valid'  ()             number of real anchors in this batch

        Decodes the :meth:`plan_batch` reads in one native call per source
        (threaded C++; nafp_tpu_torch/native/wavio.cc) or the pure-Python
        fallback.
        """
        plan = self.plan_batch(idx)
        n_valid = plan["n_valid"]
        a_paths, a_starts = plan["anchors"]
        p_paths, p_starts = plan["replicas"]

        anchors = np.zeros((self.n_anchor, self.seg_len), np.float32)
        if not self.reduce_batch_first_half:
            # query-synthesis loaders drop anchors from the output; skip
            # decoding them (halves host IO for the unseen_syn pass)
            anchors[:n_valid] = self._decode(a_paths, a_starts, self.seg_len)
        replicas = np.zeros((self.n_pos_bsz, self.seg_len), np.float32)
        if p_paths:
            replicas[:len(p_paths)] = self._decode(p_paths, p_starts,
                                                   self.seg_len)

        out = {"anchors": anchors, "replicas": replicas,
               "n_valid": np.int32(n_valid)}

        if self.bg_mix:
            out["bg"] = self._decode(*plan["bg"], self.seg_len)
        if self.ir_mix:
            out["ir"] = self._decode(*plan["ir"], MAX_IR_LENGTH)
        if self.speech_mix:
            out["speech"] = self._decode(*plan["speech"], self.seg_len)
        return out

    def _decode(self, paths, starts, out_len: int) -> np.ndarray:
        """Batch segment decode: RAM song-cache slices when enabled, else
        native C++ thread pool, else stdlib-wave (all outputs identical,
        tested)."""
        if self.cache is not None:
            out = np.empty((len(paths), out_len), np.float32)
            for i, (p, s) in enumerate(zip(paths, starts)):
                out[i] = self.cache.slice(p, int(s), out_len, self.fs)
            return out
        if self.use_native_decoder:
            out = load_segments_native(paths, starts, out_len,
                                       self.decoder_threads)
            if out is not None:
                return out
        out = np.zeros((len(paths), out_len), np.float32)
        for i, (p, s) in enumerate(zip(paths, starts)):
            out[i] = load_wav_segment(p, int(s), out_len, self.fs)
        return out

    def _plan_sources(self, idx, rng, seg_list, index, random_offset):
        """(paths, starts) for one aug source (bg/ir/speech) of batch idx."""
        n = len(seg_list)
        sel = np.arange(idx * self.n_pos_bsz, (idx + 1) * self.n_pos_bsz) % n
        paths, starts = [], []
        for si in index[sel]:
            fname, seg_idx, _, off_max = seg_list[si]
            start = int(seg_idx * self.duration * self.fs)
            if random_offset:
                off = min(int(rng.integers(0, self.seg_len // 2)), int(off_max))
                start += off
            paths.append(fname)
            starts.append(start)
        return paths, starts


def prefetch(loader: SegmentLoader, n_prefetch: int = 2):
    """Background-thread prefetch iterator (counterpart of the reference's
    OrderedEnqueuer usage, trainer.py:183-194). WAV decode is IO-bound and
    releases the GIL, so a thread suffices on this 1-core host.

    Worker exceptions are re-raised in the consumer — a decode failure must
    crash the run, not silently truncate the stream (which would leave
    zero rows in generated fingerprint memmaps).

    Traced (``utils.profiling``): the consumer's wait is the span
    ``loader.wait``; the worker, whose thread the profiler does not
    record, times each ``loader[i]`` and hands the seconds over with the
    batch, and the consumer adds them to the counter ``loader.decode_s``."""
    q: "queue.Queue" = queue.Queue(maxsize=n_prefetch)
    stop = object()

    def worker():
        try:
            for i in range(len(loader)):
                t0 = time.perf_counter()
                batch = loader[i]
                q.put((batch, time.perf_counter() - t0))
            q.put(stop)
        except BaseException as e:  # propagate to consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("loader.wait"):
            item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        batch, decode_s = item
        count("loader.decode_s", decode_s)
        yield batch
