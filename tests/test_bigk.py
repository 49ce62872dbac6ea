"""k > 128 end-to-end coverage (W > 8 words per k-mer).

The reference's ``Kmer`` is arbitrary-length (package.scala:138-503); the
repo's jnp paths are W-generic, and the native loser-tree merge takes its
generic pointer-compare heap past W = 8 (output/native/fkmerge.cpp:182).
These tests pin those boundaries end-to-end: full job, spill-scale
accumulator merge, mesh streaming, CLI.
"""

import json

import numpy as np

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch
from .test_pipeline_e2e import write_fasta


def _table_dict(words, counts, k):
    kmers = bits.decode_words_batch(words, k)
    return {km.decode(): int(c) for km, c in zip(kmers, counts.tolist())}


def test_bigk_execute_job_host_merge(tmp_path):
    """k=155 (W=10) full job on the host-merge path: multiple batches so
    merge_partials runs — on W > 8 the native merge must take (or cleanly
    fall back from) its generic heap and stay oracle-exact."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.config import JobConfig

    k, m = 155, 10
    rng = np.random.default_rng(155)
    reads = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(20)]
    fa = str(tmp_path / "bigk.fa")
    write_fasta(fa, reads)
    cfg = JobConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=k, m=m, max_b=32,
        reads_per_batch=4, read_len=256, write=True,
    )
    res = pipeline.execute_job(cfg, verbose=False)
    expect = dict(oracles.count_reads(reads, k))
    assert _table_dict(res.words, res.counts, k) == expect

    from fastkmer_tpu.output import manifest as mf, writer as writer_mod

    assert mf.verify_output(cfg.output_dir)["ok"]
    written = {
        km: c
        for d in writer_mod.read_output_dir(cfg.output_dir).values()
        for km, c in d.items()
    }
    assert written == expect


def test_bigk_accumulator_spill_merge():
    """k=155 device accumulator with a tiny acc_cap: repeated host spills,
    so finalize merges W=10 spill parts through the native generic-heap
    path (fkmerge W > 8) — oracle-exact."""
    import jax.numpy as jnp

    from fastkmer_tpu import pipeline

    k, m, B = 155, 10, 32
    rng = np.random.default_rng(7155)
    all_reads = []
    # N-free reads: at k=155 a single N invalidates 155 windows, which
    # would deflate the distinct count below any spill-forcing cap
    acc = pipeline.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=1 << 9)
    for _ in range(6):
        reads = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(4)]
        all_reads.extend(reads)
        codes = to_batch(reads, 220)
        acc.add_raw(
            pipeline._batch_extract_keys(jnp.asarray(codes), k, m, B)
        )
    words, counts, _bins = acc.finalize()
    assert len(acc.host_spills) >= 1, "acc_cap=1024 must have spilled"
    assert _table_dict(words, counts, k) == dict(oracles.count_reads(all_reads, k))


def test_bigk_mesh_streaming():
    """k=201 (W=13) over the 8-device streaming exchange: the all-to-all
    ships 13 key lanes, the per-chip tables sort 13-word keys."""
    import jax

    from fastkmer_tpu.parallel import exchange, partitioner, stream

    k, m, B = 201, 14, 64
    mesh = jax.make_mesh((8,), (exchange.AXIS,), devices=jax.devices("cpu")[:8])
    rng = np.random.default_rng(201)
    all_reads = []
    ctr = stream.DistributedCounter(
        mesh, k, m, B, cap=2048, acc_cap=1 << 14,
        owner_map=partitioner.hash_owner_map(B, 8), fanin=2,
    )
    for _ in range(3):
        reads = random_reads(rng, 8, 260)
        all_reads.extend(reads)
        ctr.feed(to_batch(reads, 260))
    words, counts, _bins = ctr.finalize()
    assert _table_dict(words, counts, k) == dict(oracles.count_reads(all_reads, k))


def test_bigk_cli(tmp_path):
    """k=129 through the CLI on a mesh — the first k past W = 8 must run
    the whole driver stack."""
    from fastkmer_tpu import cli
    from fastkmer_tpu.output import writer as writer_mod

    k = 129
    rng = np.random.default_rng(129)
    reads = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(16)]
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, reads)
    stats = str(tmp_path / "stats.json")
    rc = cli.main(
        [
            str(k), "12", "3", "32", "0", "0", fa, str(tmp_path) + "/", "bk_",
            "1", "0", "0",
            "--platform", "cpu", "--mesh", "4", "--reads-per-batch", "8",
            "--read-len", "256", "--stats-json", stats,
        ]
    )
    assert rc == 0
    s = json.load(open(stats))
    expect = dict(oracles.count_reads(reads, k))
    assert s["n_unique"] == len(expect)
    out_dir = str(tmp_path / f"bk_k{k}_m12_x3_b32_s0")
    written = {
        km: c
        for d in writer_mod.read_output_dir(out_dir).values()
        for km, c in d.items()
    }
    assert written == expect
