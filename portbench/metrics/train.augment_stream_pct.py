"""Share of the traced window in the stream interval of the train step's
augmentation (augment_replicas, log-mel, SpecAugment): the card's time
from the CUDA event at the phase's entry to the one at its exit, in %:
the port's own span ``train.augment`` (device_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. The interval holds the
device's idle time inside the phase as well as its kernels, so it bounds
the phase's kernel time from above. None where the port records no such
span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("train.augment")
    v = None if s is None else s["device_s"]
    return None if v is None else 100.0 * v / ctx.window_s
