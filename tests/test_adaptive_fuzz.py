"""Adversarial fuzz of the adaptive machinery (VERDICT r2 #9): inputs whose
duplication ratio oscillates across the pre-dedup engage threshold, sized so
the dedup compaction cap is GENUINELY smaller than a distinct-heavy batch's
unique count — mode switches, lossless overflow fallbacks, and host spills
must all compose into an exact table.  Mesh side: exchange-overflow retries
and accumulator spills in the same streaming run.
"""

import numpy as np
import pytest

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch

K, M, B = 13, 6, 32
L = 300  # npos/batch = 64*288 = 18432 > dedup cap 16384 -> overflow possible


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from fastkmer_tpu.parallel import exchange

    return jax.make_mesh((8,), (exchange.AXIS,), devices=jax.devices("cpu")[:8])


def genome_reads(rng, genome: str, n: int, length: int):
    """Reads sampled from one small genome: heavy duplication (in-batch
    distinct ratio << the engage threshold)."""
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(genome) - length + 1))
        out.append(genome[s : s + length])
    return out


def run_and_check(all_reads, batches, spy=None, **kw):
    from fastkmer_tpu import pipeline

    res = pipeline.count_batches(
        iter(batches), K, M, B, device_accumulate=True, **kw
    )
    expect = oracles.count_reads(all_reads, K)
    kmers = bits.decode_words_batch(res.words, K)
    got = {km.decode(): int(c) for km, c in zip(kmers, res.counts.tolist())}
    assert got == dict(expect)
    return res


def test_forced_prededup_on_distinct_heavy_is_lossless():
    """prededup=True on distinct-heavy input: EVERY batch's unique count
    exceeds the compaction cap; the overflow fallback must recount each
    batch raw (not drop uniques, not abort)."""
    rng = np.random.default_rng(41)
    all_reads, batches = [], []
    for _ in range(6):
        reads = random_reads(rng, 64, L, n_prob=0.0)
        all_reads.extend(reads)
        batches.append((to_batch(reads, L), len(reads), sum(map(len, reads))))
    run_and_check(all_reads, batches, prededup=True)


def test_adaptive_oscillation_with_spills_exact(monkeypatch):
    """Duplication ratio flips right after each probe batch (the worst case
    for a 16-batch probe cadence): dedup engages on dup-heavy phases, runs
    blind into distinct-heavy batches (cap overflow -> raw fallback +
    disengage), re-engages later; the accumulator spills mid-run.  The
    final table must be exact."""
    from fastkmer_tpu import pipeline

    dedup_calls = {"n": 0}
    orig_dedup = pipeline._batch_count_dedup

    def spy_dedup(*a, **k):
        dedup_calls["n"] += 1
        return orig_dedup(*a, **k)

    monkeypatch.setattr(pipeline, "_batch_count_dedup", spy_dedup)

    spills = {"n": 0}
    orig_spill = pipeline.DeviceAccumulator._spill

    def spy_spill(self, stats):
        if stats["n_unique"]:
            spills["n"] += 1
        return orig_spill(self, stats)

    monkeypatch.setattr(pipeline.DeviceAccumulator, "_spill", spy_spill)

    rng = np.random.default_rng(42)
    genome = "".join(rng.choice(list("ACGT"), size=150))
    all_reads, batches = [], []
    # phases flip at probe boundaries (probe every 16): dup 0-15,
    # distinct 16-31, dup 32-47
    for phase in ("dup", "distinct", "dup"):
        for _ in range(16):
            if phase == "dup":
                reads = genome_reads(rng, genome, 64, 120)
            else:
                reads = random_reads(rng, 64, L, n_prob=0.0)
            all_reads.extend(reads)
            batches.append((to_batch(reads, L), len(reads), sum(map(len, reads))))
    run_and_check(all_reads, batches, prededup=None)
    assert dedup_calls["n"] > 0, "adaptive mode never engaged pre-dedup"
    assert spills["n"] > 0, "run never spilled (resize workload)"


def test_adaptive_controller_is_deterministic(monkeypatch):
    """Two identical adaptive runs must make IDENTICAL mode decisions and
    merge-window compositions (dispatch kinds + merge points): admission
    happens at a fixed dispatch-index lag, never on scalar-landing timing.
    Nondeterministic compositions would retrace the merge jit per run."""
    from fastkmer_tpu import pipeline

    def run_once():
        trace = []
        orig_dedup = pipeline._batch_count_dedup
        orig_append = pipeline.DeviceAccumulator._append
        orig_merge = pipeline.DeviceAccumulator._merge_pending

        def spy_dedup(*a, **k):
            trace.append("D")
            return orig_dedup(*a, **k)

        def spy_append(self, part, n):
            cols, wts = part
            trace.append(("append", int(cols[0].shape[0]), wts is not None))
            return orig_append(self, part, n)

        def spy_merge(self):
            if self.pending:
                trace.append(("merge", len(self.pending)))
            return orig_merge(self)

        import unittest.mock as mock

        with mock.patch.object(pipeline, "_batch_count_dedup", spy_dedup), \
             mock.patch.object(pipeline.DeviceAccumulator, "_append", spy_append), \
             mock.patch.object(pipeline.DeviceAccumulator, "_merge_pending", spy_merge):
            rng = np.random.default_rng(77)
            genome = "".join(rng.choice(list("ACGT"), size=150))
            batches, all_reads = [], []
            for phase in ("dup", "distinct", "dup"):
                for _ in range(8):
                    if phase == "dup":
                        reads = genome_reads(rng, genome, 64, 120)
                    else:
                        reads = random_reads(rng, 64, L, n_prob=0.0)
                    all_reads.extend(reads)
                    batches.append(
                        (to_batch(reads, L), len(reads), sum(map(len, reads)))
                    )
            run_and_check(all_reads, batches, prededup=None)
        return trace

    t1 = run_once()
    t2 = run_once()
    assert t1 == t2
    assert "D" in t1  # the adaptive path actually engaged dedup attempts


def test_streaming_retry_and_spill_same_run(mesh8):
    """Mesh streaming with BOTH pressure valves firing in one run: an
    exchange cap small enough to drop entries (resize-and-retry) and an
    acc_cap small enough to force host spills — and the table still exact."""
    from fastkmer_tpu.parallel import partitioner, stream

    k, m, b = 28, 10, 64
    rng = np.random.default_rng(43)
    all_reads = []
    ctr = stream.DistributedCounter(
        mesh8, k, m, b, cap=16, acc_cap=512,
        owner_map=partitioner.hash_owner_map(b, 8),
    )
    for _ in range(6):
        reads = random_reads(rng, 32, 100, n_prob=0.0)
        all_reads.extend(reads)
        ctr.feed(to_batch(reads, 100), n_reads=len(reads))
    words, counts, bins = ctr.finalize()

    assert ctr.n_retries >= 1, "exchange never hit the resize-and-retry path"
    assert len(ctr.host_spills) >= 1, "accumulator never spilled"
    expect = oracles.count_reads(all_reads, k)
    kmers = bits.decode_words_batch(words, k)
    got = {km.decode(): int(c) for km, c in zip(kmers, counts.tolist())}
    assert got == dict(expect)
