"""The benchmark of ``nafp_tpu_torch``, the PyTorch + CUDA port, on one card.

One command runs one cell (one entry of ``workloads`` in the repository's
``BENCHMARK.json``) once, in a process of its own:

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Everything here is found by name, so a later cell, configuration, traffic
mix or per-layer metric is a new file and a new entry:

- ``configs/<config>.json``: the deployment (model widths, DB and index);
- ``traffic/<mix>.json``: the parameters of a traffic mix and the name of
  the runner (``runners/<runner>.py``) that generates and serves it;
- ``workloads/<cell>.json``: the limits of the cell's output comparison;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/``: the plain PyTorch reference the outputs are held to.

Nothing here imports ``jax``, ``flax`` or the JAX package ``nafp_tpu``;
``reference/`` imports nothing of ``nafp_tpu_torch`` either.
"""
