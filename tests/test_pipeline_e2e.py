"""End-to-end golden tests: full pipeline on small FASTA files diffed
against the naive dict-based oracle — the test the reference never had but
whose workflow it approximated by diffing output dirs between configurations
(SURVEY.md §4)."""

import numpy as np
import pytest

from fastkmer_tpu.config import JobConfig
from fastkmer_tpu.core import bits
from fastkmer_tpu.output import writer

from . import oracles


def write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read{i}\n")
            # multi-line records to exercise newline stripping
            for j in range(0, len(r), 37):
                f.write(r[j : j + 37] + "\n")


@pytest.fixture
def small_reads():
    rng = np.random.default_rng(7)
    reads = []
    for _ in range(40):
        length = int(rng.integers(20, 200))
        chars = rng.choice(list("ACGT"), size=length)
        mask = rng.random(length) < 0.02
        chars[mask] = "N"
        reads.append("".join(chars))
    return reads


def result_as_dict(res, k):
    kmers = bits.decode_words_batch(res.words, k)
    return {km.decode(): int(c) for km, c in zip(kmers, res.counts.tolist())}


def test_e2e_short_mode(tmp_path, small_reads):
    from fastkmer_tpu import pipeline

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    k, m = 28, 10
    cfg = JobConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=k, m=m, max_b=64,
        reads_per_batch=16, read_len=256,
    )
    res = pipeline.execute_job(cfg, verbose=False)

    expect = oracles.count_reads(small_reads, k)
    got = result_as_dict(res, k)
    assert got == dict(expect)
    assert res.n_instances == sum(expect.values())

    # per-bin files match the binned oracle exactly (same signature hash)
    on_disk = writer.read_output_dir(cfg.output_dir)
    expect_binned = oracles.count_reads_binned(small_reads, k, m, cfg.b)
    assert {b: dict(c) for b, c in expect_binned.items()} == on_disk

    # files are sorted with EOF sentinel
    import os

    some_bin = sorted(on_disk)[0]
    raw = open(os.path.join(cfg.output_dir, f"bin{some_bin}"), "rb").read()
    assert raw.endswith(b"EOF")
    lines = [l.split(b"\t")[0] for l in raw[:-3].splitlines()]
    assert lines == sorted(lines)


def test_e2e_long_mode_chunking_lossless(tmp_path):
    """sequence_type=1: a genome longer than read_len is chunked with k-1
    overlap; counts must equal the unchunked oracle (the FASTdoop
    PartialSequence overlap guarantee, SparkBinKmerCounter.scala:993)."""
    from fastkmer_tpu import pipeline

    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    # plant an N island to exercise splits across chunk boundaries
    genome = genome[:1500] + "NNN" + genome[1503:]
    fa = str(tmp_path / "genome.fa")
    write_fasta(fa, [genome])
    k, m = 28, 10
    cfg = JobConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=k, m=m, max_b=64,
        sequence_type=1, reads_per_batch=8, read_len=512, write=False,
    )
    res = pipeline.execute_job(cfg, verbose=False)
    expect = oracles.count_reads([genome], k)
    assert result_as_dict(res, k) == dict(expect)


@pytest.mark.parametrize("k,m", [(28, 10), (55, 8)])
def test_cross_engine_equality(tmp_path, small_reads, k, m):
    """Sort and HT engines must produce identical tables — the validation
    workflow the reference used across useHT configs (SURVEY.md §4).
    k=55 exercises the fingerprint (W=4) path where HT differs for real."""
    from fastkmer_tpu import pipeline

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    base = dict(
        dataset=fa, output_directory=str(tmp_path) + "/", k=k, m=m, max_b=64,
        reads_per_batch=16, read_len=256, write=False,
    )
    res_sort = pipeline.execute_job(JobConfig(**base), verbose=False)
    res_ht = pipeline.execute_job(JobConfig(**base, use_ht=True), verbose=False)
    assert result_as_dict(res_sort, k) == result_as_dict(res_ht, k)
    assert res_sort.n_instances == res_ht.n_instances
    expect = oracles.count_reads(small_reads, k)
    assert result_as_dict(res_sort, k) == dict(expect)


def test_e2e_k_multiple_of_16_all_T_vs_sentinel(tmp_path):
    """k=32 (words exactly fill, no zero padding): the all-T k-mer's words
    equal the invalid-padding sentinel pattern; the validity sort key must
    keep them apart."""
    from fastkmer_tpu import pipeline

    reads = ["T" * 40, "T" * 33, "ACGT" * 10]
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, reads)
    cfg = JobConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=32, m=6, max_b=64,
        reads_per_batch=4, read_len=64, write=False,
    )
    res = pipeline.execute_job(cfg, verbose=False)
    expect = oracles.count_reads(reads, 32)
    assert result_as_dict(res, 32) == dict(expect)
    # all-T canonical is all-A (RC): check explicitly
    assert "A" * 32 in result_as_dict(res, 32)


def test_device_accumulator_matches_host_merge(tmp_path, small_reads):
    """Forced device-resident accumulation must equal the host-merge path."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    k, m, B = 28, 10, 64

    def run(dev_acc):
        batches = batching.batch_file(fa, 0, k, 16, 256)
        return pipeline.count_batches(batches, k, m, B, device_accumulate=dev_acc)

    a = run(False)
    b = run(True)
    np.testing.assert_array_equal(a.words, b.words)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.bins, b.bins)
    assert a.n_instances == b.n_instances

    # tiny fan-in to force multiple collapse rounds
    acc = pipeline.DeviceAccumulator(k, fanin=2, m=m, B=B)
    import jax.numpy as jnp

    for codes, _, _ in batching.batch_file(fa, 0, k, 8, 256):
        acc.add(pipeline._batch_count(jnp.asarray(codes), k, m, B))
    words, counts, bins = acc.finalize()
    np.testing.assert_array_equal(words, a.words)
    np.testing.assert_array_equal(counts, a.counts)
    np.testing.assert_array_equal(bins, a.bins)


def test_device_accumulator_unique_ub_sync_free(tmp_path, small_reads):
    """unique_ub (caller-asserted distinct bound) disables all host-side
    room checks; the result must still be exact and finalize must verify
    the assertion via the device overflow counter."""
    import pytest

    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    k, m, B = 28, 10, 64

    batches = batching.batch_file(fa, 0, k, 16, 256)
    ref = pipeline.count_batches(batches, k, m, B, device_accumulate=False)

    res = pipeline.count_batches(
        batching.batch_file(fa, 0, k, 16, 256), k, m, B,
        device_accumulate=True, unique_ub=len(ref.counts),
    )
    np.testing.assert_array_equal(res.words, ref.words)
    np.testing.assert_array_equal(res.counts, ref.counts)
    assert res.n_instances == ref.n_instances

    # a WRONG assertion (cap below the true distinct count) must raise at
    # finalize, never lose counts silently
    acc = pipeline.DeviceAccumulator(k, fanin=2, m=m, B=B,
                                     acc_cap=16, unique_ub=16)
    assert acc.assume_fits
    import jax.numpy as jnp

    for codes, _, _ in batching.batch_file(fa, 0, k, 8, 256):
        acc.add(pipeline._batch_count(jnp.asarray(codes), k, m, B))
    with pytest.raises(RuntimeError, match="overflow"):
        acc.finalize()


def test_device_accumulator_k_multiple_of_16(tmp_path):
    """k % 16 == 0 through the deferred accumulator: the constant-zero
    validity lane must keep all-T k-mers apart from the sentinel."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    rng = np.random.default_rng(13)
    reads = ["T" * 50, "A" * 40, "T" * 33] + [
        "".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04], size=120))
        for _ in range(30)
    ]
    fa = str(tmp_path / "t16.fa")
    write_fasta(fa, reads)
    for k, m in ((32, 9), (16, 6)):
        ref = pipeline.count_batches(
            batching.batch_file(fa, 0, k, 8, 256), k, m, 64,
            device_accumulate=False,
        )
        res = pipeline.count_batches(
            batching.batch_file(fa, 0, k, 8, 256), k, m, 64,
            device_accumulate=True,
        )
        np.testing.assert_array_equal(res.words, ref.words, err_msg=f"k={k}")
        np.testing.assert_array_equal(res.counts, ref.counts, err_msg=f"k={k}")
        np.testing.assert_array_equal(res.bins, ref.bins, err_msg=f"k={k}")
        assert res.n_instances == ref.n_instances
        # the all-T / all-A canonical k-mer must have survived the sentinel
        from fastkmer_tpu.core import bits

        table = {bits.words_to_str(w, k) for w in res.words}
        assert "A" * k in table


def test_prededup_modes_match(tmp_path):
    """Per-batch pre-dedup (forced and adaptive) must be output-identical
    to the raw deferred path on a duplication-heavy input."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    # 60 reads sampled from a 300 bp genome -> very heavy duplication
    reads = []
    for _ in range(60):
        s = int(rng.integers(0, 200))
        reads.append(genome[s : s + int(rng.integers(60, 100))])
    fa = str(tmp_path / "dup.fa")
    write_fasta(fa, reads)
    k, m, B = 25, 8, 64

    def run(**kw):
        return pipeline.count_batches(
            batching.batch_file(fa, 0, k, 8, 256), k, m, B,
            device_accumulate=True, **kw,
        )

    ref = pipeline.count_batches(
        batching.batch_file(fa, 0, k, 8, 256), k, m, B, device_accumulate=False
    )
    for kw in ({"prededup": True}, {"prededup": False}, {}):
        res = run(**kw)
        np.testing.assert_array_equal(res.words, ref.words, err_msg=str(kw))
        np.testing.assert_array_equal(res.counts, ref.counts, err_msg=str(kw))
        np.testing.assert_array_equal(res.bins, ref.bins, err_msg=str(kw))
        assert res.n_instances == ref.n_instances


def test_device_accumulator_small_cap_spills(tmp_path, small_reads):
    """A cap far below the distinct count forces host spills mid-stream
    (and, on CPU, exercises the non-blocking _refresh_landed tightening);
    the spilled+merged table must equal the host-merge path."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    k, m, B = 28, 10, 64

    ref = pipeline.count_batches(
        batching.batch_file(fa, 0, k, 16, 256), k, m, B, device_accumulate=False
    )
    assert len(ref.counts) > 1024  # cap must be exceeded overall ...

    import jax.numpy as jnp

    # ... while each fanin window's distinct count still fits the cap
    acc = pipeline.DeviceAccumulator(k, fanin=2, m=m, B=B, acc_cap=1024)
    for codes, _, _ in batching.batch_file(fa, 0, k, 4, 256):
        acc.add_raw(pipeline._batch_extract_keys(jnp.asarray(codes), k, m, B))
    assert acc.host_spills  # the point of the test
    words, counts, bins = acc.finalize()
    np.testing.assert_array_equal(words, ref.words)
    np.testing.assert_array_equal(counts, ref.counts)
    np.testing.assert_array_equal(bins, ref.bins)


def test_device_accumulator_spill_inflight_bound(tmp_path, small_reads,
                                                 monkeypatch):
    """Async spills must not pin unbounded device buffers: with the
    opportunistic landing path disabled (simulating a link slower than the
    spill cadence), pending un-materialized spills stay within
    MAX_INFLIGHT_SPILLS and finalize still matches the host-merge path."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ingest import batch as batching

    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, small_reads)
    k, m, B = 28, 10, 64

    ref = pipeline.count_batches(
        batching.batch_file(fa, 0, k, 16, 256), k, m, B, device_accumulate=False
    )

    orig = pipeline.DeviceAccumulator.materialize_spills

    def lazy_only(self, block=True):
        if block:
            orig(self, block=True)

    monkeypatch.setattr(pipeline.DeviceAccumulator, "materialize_spills",
                        lazy_only)

    import jax.numpy as jnp

    acc = pipeline.DeviceAccumulator(k, fanin=1, m=m, B=B, acc_cap=1024)
    max_pending = 0
    for codes, _, _ in batching.batch_file(fa, 0, k, 4, 256):
        acc.add_raw(pipeline._batch_extract_keys(jnp.asarray(codes), k, m, B))
        pending = sum(1 for s in acc.host_spills if not isinstance(s, tuple))
        max_pending = max(max_pending, pending)
        assert pending <= acc.MAX_INFLIGHT_SPILLS
    assert len(acc.host_spills) > acc.MAX_INFLIGHT_SPILLS, \
        "workload too small to exercise the bound"
    assert max_pending > 0, "opportunistic landing was not actually disabled"
    words, counts, bins = acc.finalize()
    np.testing.assert_array_equal(words, ref.words)
    np.testing.assert_array_equal(counts, ref.counts)
    np.testing.assert_array_equal(bins, ref.bins)
