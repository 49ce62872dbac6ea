"""Multi-chip tests on the 8-virtual-device CPU mesh: the all-to-all bin
exchange must produce the same global count table as the single-chip path
and the dict oracle, under both hash and LPT ownership — the device analogue of
validating Spark shuffle semantics with local[4] (SURVEY.md §4)."""

import numpy as np
import pytest

from fastkmer_tpu.core import bits
from fastkmer_tpu.parallel import partitioner

from . import oracles
from .test_extract import random_reads, to_batch


@pytest.fixture(scope="module")
def mesh8():
    import jax

    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest must force 8 virtual CPU devices"
    return jax.make_mesh((8,), ("data",), devices=devs[:8])


def _global_table(shard_parts, k):
    from fastkmer_tpu import pipeline

    W = bits.num_words(k)
    words, counts, bins = pipeline.merge_partials(shard_parts, W)
    kmers = bits.decode_words_batch(words, k)
    return {km.decode(): int(c) for km, c in zip(kmers, counts.tolist())}, bins, words, counts


class TestLPT:
    def test_lpt_balances_and_permutes(self):
        sizes = np.array([100, 90, 10, 10, 5, 5, 0, 0])
        owners = partitioner.lpt_owner_map(sizes, 2)
        # two heaviest bins must land on different partitions
        assert owners[0] != owners[1]
        stats = partitioner.balance_stats(sizes, owners, 2)
        assert stats["total"] == 220
        assert stats["imbalance"] < 1.1
        # unseen bins use the hash fallback bin % n
        assert owners[6] == 6 % 2 and owners[7] == 7 % 2

    def test_lpt_fixed_seed_deterministic(self):
        sizes = np.arange(32)[::-1].copy()
        a = partitioner.lpt_owner_map(sizes, 4)
        b = partitioner.lpt_owner_map(sizes, 4)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_lpt", [False, True])
def test_distributed_count_matches_oracle(mesh8, use_lpt):
    import jax

    from fastkmer_tpu.parallel import exchange

    k, m, B = 28, 10, 64
    rng = np.random.default_rng(5)
    L = 120
    reads = random_reads(rng, 64, L)  # 8 rows per chip
    codes = to_batch(reads, L)

    if use_lpt:
        est = exchange.estimate_bin_sizes(mesh8, k, m, B)
        hist = np.asarray(est(exchange.shard_batch(mesh8, codes)))
        owner_map = partitioner.lpt_owner_map(hist, 8)
        assert hist.sum() > 0
    else:
        owner_map = partitioner.hash_owner_map(B, 8)

    cap = 2048  # plenty for this size
    step = exchange.build_distributed_count(mesh8, k, m, B, cap, owner_map)
    sc = step(exchange.shard_batch(mesh8, codes))
    jax.block_until_ready(sc.counts)
    assert int(sc.dropped) == 0

    parts = exchange.compact_shard_counts(sc)
    got, got_bins, got_words, got_counts = _global_table(parts, k)
    expect = oracles.count_reads(reads, k)
    assert got == dict(expect)

    # every unique k-mer must have been counted on its bin's owner chip
    for c, (w, cnt, b) in enumerate(parts):
        if b.size:
            assert (owner_map[b] == c).all()

    # per-bin grouping matches binned oracle
    expect_binned = oracles.count_reads_binned(reads, k, m, B)
    got_binned: dict = {}
    kmers = bits.decode_words_batch(got_words, k)
    for km, cnt, b in zip(kmers, got_counts.tolist(), got_bins.tolist()):
        got_binned.setdefault(b, {})[km.decode()] = cnt
    assert got_binned == {b: dict(c) for b, c in expect_binned.items()}


def test_capacity_overflow_detected(mesh8):
    from fastkmer_tpu.parallel import exchange

    k, m, B = 16, 6, 16
    rng = np.random.default_rng(9)
    reads = random_reads(rng, 32, 64, n_prob=0.0)
    codes = to_batch(reads, 64)
    owner_map = partitioner.hash_owner_map(B, 8)
    step = exchange.build_distributed_count(mesh8, k, m, B, cap=8, owner_map=owner_map)
    sc = step(exchange.shard_batch(mesh8, codes))
    assert int(sc.dropped) > 0  # tiny capacity must overflow and be reported


def test_multihost_helpers_single_process():
    from fastkmer_tpu.parallel import multihost

    multihost.init_distributed()  # no-op in single process
    mesh = multihost.init_global_mesh()
    assert mesh.shape["data"] >= 1
    lo, hi = multihost.host_stripe(10)
    assert (lo, hi) == (0, 10)
    assert list(multihost.stripe_batches(range(5), n_hosts=1, host_id=0)) == [0, 1, 2, 3, 4]
    assert list(multihost.stripe_batches(range(5), n_hosts=2, host_id=1)) == [1, 3]
