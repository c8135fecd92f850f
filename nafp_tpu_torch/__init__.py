"""nafp_tpu_torch — neural audio fingerprinting in PyTorch on an NVIDIA GPU.

The PyTorch + CUDA port of ``nafp_tpu`` (the JAX package stays in this
repository as the reference). Module names mirror the JAX package's so
each counterpart is easy to find. This package imports ``torch`` and never
``jax`` or ``nafp_tpu``.

Ported so far: the serving path (log-mel frontend, FingerPrinter encoder,
fingerprint generation to memmaps, exact search (``l2``/``ip``/``ivf`` over
f32, ``sq8``/``sq8-flat`` over int8), IVF-PQ, with hand-written CUDA top-k
kernels, and the ICASSP sequence-search protocol) and the training path
(NT-Xent, Adam/LAMB, time-domain and spectral augmentation, the trainer
with checkpoints and resume, the in-training mini-search), and their
multi-device forms (the sharded indexes, generate over several cards,
data-parallel training with one process per card on
``torch.distributed``).

Package layout
--------------
- ``device``   — explicit device resolution (CUDA unless the CPU is asked for)
- ``ops``      — DSP frontend (log-mel), time-domain and spectral augmentation
- ``models``   — the FingerPrinter encoder and the Flax <-> torch converter
- ``data``     — audio IO, segment catalogs, host batch loader
- ``losses``   — NT-Xent
- ``optim``    — LAMB, the learning-rate schedules, optimizer selection
- ``train``    — the trainer and its checkpoint/metrics helper
- ``parallel`` — devices of a data-parallel pass, process groups, collectives
- ``utils``    — profiling, and the spans and counters the profiler records
- ``search``   — top-k kernels, indexes (sharded ones too), sequence
                 re-ranking, evaluation, the in-training mini-search
- ``csrc``     — CUDA C++ sources of the kernels (built with nvcc at first use)
"""

__version__ = "0.1.0"
