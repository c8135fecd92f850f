"""Command line of nafp_tpu_torch: generate -> evaluate (train: not ported).

Counterpart of ``nafp_tpu/cli.py`` with the same verbs and flags. Every
command runs on ``cuda:0`` unless ``--nogpu`` asks for the CPU; without a
card and without ``--nogpu`` it raises instead of moving to the CPU.

    python -m nafp_tpu_torch.cli generate NAME [INDEX] [-c CONFIG] ...
    python -m nafp_tpu_torch.cli evaluate NAME INDEX [-i TYPE]  # ivfpq default
"""
from __future__ import annotations

import click

from nafp_tpu_torch.configuration import load_config, update_config


@click.group()
def main():
    """Neural audio fingerprinting on the GPU: generate -> evaluate.

    Run COMMAND --help for per-command usage.
    """


@main.command(context_settings={"ignore_unknown_options": True,
                                "allow_extra_args": True})
@click.argument("checkpoint_name", required=True)
def train(checkpoint_name):
    """Not ported yet (the training slice, ROADMAP.md)."""
    del checkpoint_name
    raise click.ClickException(
        "train is not ported yet (the training slice, ROADMAP.md items "
        "6-8); train with the JAX package and export its params (README)")


@main.command()
@click.argument("checkpoint_name", required=True)
@click.argument("checkpoint_index", required=False, type=click.INT)
@click.option("--config", "-c", default="default", type=click.STRING,
              help="Config preset name; resolved to config/<NAME>.yaml.")
@click.option("--source", "-s", default=None, type=click.STRING,
              help="Custom source root directory (16-bit 8 kHz mono WAV); "
                   "builds a database without synthesizing queries.")
@click.option("--output", "-o", default=None, type=click.STRING,
              help="Root directory for generated embeddings. Default is "
                   "OUTPUT_ROOT_DIR/CHECKPOINT_NAME from config.")
@click.option("--skip_dummy", default=False, is_flag=True,
              help="Exclude dummy-DB from the default source.")
@click.option("--yes", "-y", default=False, is_flag=True,
              help="Skip the dummy_db overwrite confirmation prompt.")
@click.option("--act_store", default=None,
              type=click.Choice(["int8", "fp8"]),
              help="Store inter-layer activations at 1 byte/elem (not "
                   "ported yet: raises).")
@click.option("--nogpu", default=False, is_flag=True,
              help="Run on the CPU instead of cuda:0.")
def generate(checkpoint_name, checkpoint_index, config, source, output,
             skip_dummy, yes, act_store, nogpu):
    """Extract fingerprint memmaps with a saved checkpoint.

    Reads LOG_ROOT_DIR/checkpoint/CHECKPOINT_NAME/CHECKPOINT_INDEX/
    params.npz (newest index when omitted) and writes
    {dummy_db,db,query}.mm (+ sidecar shape files) for the evaluate step.
    """
    from nafp_tpu_torch.device import resolve_device
    from nafp_tpu_torch.generate import generate_fingerprint

    device = resolve_device(nogpu=nogpu)
    cfg = load_config(config)
    if act_store:
        update_config(cfg, "MODEL", "ACT_STORE", act_store)
    generate_fingerprint(cfg, checkpoint_name, checkpoint_index, source,
                         output, skip_dummy, assume_yes=yes, device=device)


@main.command()
@click.argument("checkpoint_name", required=True)
@click.argument("checkpoint_index", required=True)
@click.option("--config", "-c", default="default", type=click.STRING,
              help="Config preset name; resolved to config/<NAME>.yaml.")
@click.option("--index_type", "-i", default="ivfpq", type=click.STRING,
              help="Ported: 'ivfpq' (default; IVF-PQ, nlist 256, 8-bit "
                   "codes), 'ivfpq-rr' (IVF-PQ + exact f32 re-rank), 'l2', "
                   "'ip', 'ivf' (exact f32), 'sq8', 'sq8-flat' (exact "
                   "int8). The JAX package's other types ('ivf-sq8', "
                   "'hnsw', the sharded ones) raise until they are ported.")
@click.option("--test_seq_len", default="1 3 5 9 11 19", type=click.STRING,
              help="Space-separated segment counts to test "
                   "(default '1 3 5 9 11 19' = 1s..10s).")
@click.option("--test_ids", "-t", default="icassp", type=click.STRING,
              help="One of {'all', 'icassp', 'path/file.npy', (int)}.")
@click.option("--emb_dummy_dir", default=None, type=click.STRING,
              help="Directory containing dummy_db.mm/_shape.npy to use "
                   "instead of EMB_DIR (parity with eval_faiss.py).")
@click.option("--nprobe", default=40, type=click.INT,
              help="Probed coarse lists for the IVF index family "
                   "(reference default 40); ignored by exact indexes.")
@click.option("--k_probe", default=20, type=click.INT,
              help="Per-segment top-k candidates fed to the sequence "
                   "re-ranker (reference default 20).")
@click.option("--max_train", default=int(1e7), type=click.INT,
              help="Max vectors subsampled for index training "
                   "(reference default 1e7).")
@click.option("--index_cache", default=None, type=click.STRING,
              help="npz path for the built int8 store (sq8/sq8-flat): "
                   "loaded when present, written after a fresh build. "
                   "IVF-PQ stores are not cached (as in the JAX package).")
@click.option("--ef_search", default=64, type=click.INT,
              help="Query-time beam width for the hnsw index; ignored by "
                   "the ported (exact) families.")
@click.option("--nogpu", default=False, is_flag=True,
              help="Run the search on the CPU instead of cuda:0.")
def evaluate(checkpoint_name, checkpoint_index, config, index_type,
             test_seq_len, test_ids, emb_dummy_dir, nprobe, k_probe,
             max_train, index_cache, ef_search, nogpu):
    """Run the ICASSP retrieval protocol over generated fingerprints.

    Searches query segments against dummy_db+db and reports top1-exact/
    top1-near/top3/top10 hit rates per query length.
    """
    from nafp_tpu_torch.device import resolve_device
    from nafp_tpu_torch.search.evaluate import eval_fingerprints

    device = resolve_device(nogpu=nogpu)
    cfg = load_config(config)
    emb_dir = (cfg["DIR"]["OUTPUT_ROOT_DIR"].rstrip("/") + "/" +
               checkpoint_name + "/" + str(checkpoint_index) + "/")
    eval_fingerprints(emb_dir, emb_dummy_dir=emb_dummy_dir,
                      index_type=index_type, test_ids=test_ids,
                      test_seq_len=test_seq_len, k_probe=k_probe,
                      max_train=max_train, nprobe=nprobe,
                      index_cache=index_cache, ef_search=ef_search,
                      device=device)


if __name__ == "__main__":
    main()
