"""Super-k-mer grouping/expansion tests: runs must partition exactly the
valid windows, share their run's signature bin, expand back to the original
canonical k-mers, and the super-k-mer exchange must count identically to the
per-k-mer exchange and the oracle."""

import numpy as np
import pytest

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch


@pytest.mark.parametrize("k,m,smax", [(28, 10, 64), (13, 4, 32)])
def test_group_partitions_windows(k, m, smax):
    import jax
    import jax.numpy as jnp

    from fastkmer_tpu.ops import superkmer

    B = 64
    rng = np.random.default_rng(3)
    L = 96
    reads = random_reads(rng, 10, L)
    codes = to_batch(reads, L)
    sk, ex = jax.jit(lambda c: superkmer.group(c, k, m, B, smax))(jnp.asarray(codes))

    P = L - k + 1
    is_start = np.asarray(sk.is_start).reshape(-1, P)
    n_kmers = np.asarray(sk.n_kmers).reshape(-1, P)
    bins = np.asarray(sk.bins).reshape(-1, P)
    valid = np.asarray(ex.valid).reshape(-1, P)
    sigs = np.asarray(ex.sigs).reshape(-1, P)

    cap = smax - k + 1
    for r in range(len(reads)):
        covered = np.zeros(P, dtype=bool)
        for i in range(P):
            if is_start[r, i]:
                ln = int(n_kmers[r, i])
                assert 1 <= ln <= cap
                # run is valid, signature-constant, and its bin is shared
                assert valid[r, i : i + ln].all()
                assert (sigs[r, i : i + ln] == sigs[r, i]).all()
                assert not covered[i : i + ln].any()
                covered[i : i + ln] = True
                assert bins[r, i] == bits.hash_to_bucket(int(sigs[r, i]), B)
        # every valid window is covered by exactly one run
        np.testing.assert_array_equal(covered, valid[r])


@pytest.mark.parametrize("k,smax", [(28, 64), (13, 32), (32, 48)])
def test_expand_roundtrip(k, smax):
    """group -> gather started records -> expand == extract's canonical words."""
    import jax
    import jax.numpy as jnp

    from fastkmer_tpu.ops import superkmer

    m, B = 6, 64
    rng = np.random.default_rng(4)
    L = 96
    reads = random_reads(rng, 8, L, n_prob=0.02)
    codes = to_batch(reads, L)
    sk, ex = jax.jit(lambda c: superkmer.group(c, k, m, B, smax))(jnp.asarray(codes))

    payload = np.asarray(sk.payload)
    n_kmers = np.asarray(sk.n_kmers)
    bins = np.asarray(sk.bins)
    starts = np.flatnonzero(np.asarray(sk.is_start))
    if starts.size == 0:
        pytest.skip("no runs in sample")
    kw, kv, kb = jax.jit(lambda p, nk, b: superkmer.expand(p, nk, b, k, smax))(
        jnp.asarray(payload[starts]), jnp.asarray(n_kmers[starts]), jnp.asarray(bins[starts])
    )
    kw, kv, kb = np.asarray(kw), np.asarray(kv), np.asarray(kb)

    P = L - k + 1
    ex_words = np.asarray(ex.words)
    for row, flat in enumerate(starts.tolist()):
        ln = int(n_kmers[flat])
        assert kv[row, :ln].all() and not kv[row, ln:].any()
        for j in range(ln):
            np.testing.assert_array_equal(kw[row, j], ex_words[flat + j], err_msg=f"{row},{j}")
            assert kb[row, j] == bins[flat]


def test_smer_exchange_matches_oracle():
    import jax

    from fastkmer_tpu.parallel import exchange, partitioner

    k, m, B, smax = 28, 10, 64, 64
    mesh = jax.make_mesh((8,), (exchange.AXIS,), devices=jax.devices("cpu")[:8])
    rng = np.random.default_rng(6)
    reads = random_reads(rng, 64, 120)
    codes = to_batch(reads, 120)
    owner_map = partitioner.hash_owner_map(B, 8)
    step = exchange.build_distributed_count_smer(mesh, k, m, B, 512, smax, owner_map)
    sc = step(exchange.shard_batch(mesh, codes))
    assert int(sc.dropped) == 0

    from fastkmer_tpu import pipeline

    parts = exchange.compact_shard_counts(sc)
    words, counts, bins = pipeline.merge_partials(parts, bits.num_words(k))
    kmers = bits.decode_words_batch(words, k)
    got = {km.decode(): int(c) for km, c in zip(kmers, counts.tolist())}
    assert got == dict(oracles.count_reads(reads, k))

    # shuffle-bytes accounting: per-record lane math.  Sentinel-safe k
    # ships the key words only (dead slots ARE the sentinel — no ok lane);
    # k % 16 == 0 still needs the ok lane; smer records ship payload +
    # n_kmers (unfilled slots ship n_kmers=0).
    assert exchange.exchange_bytes_per_step(8, 512, k) == 8 * 512 * bits.num_words(k) * 4
    assert exchange.exchange_bytes_per_step(8, 512, 32) == 8 * 512 * (bits.num_words(32) + 1) * 4
    assert exchange.exchange_bytes_per_step(8, 512, k, smax) == 8 * 512 * (smax // 16 + 1) * 4


def test_smer_exchange_engines_match_oracle():
    """The smer transport's per-chip tables must match the oracle with the
    sort engine, and HT counting on the expanded rows (the reference's
    literal useHT shape) must match it too."""
    import jax

    from fastkmer_tpu import pipeline
    from fastkmer_tpu.parallel import exchange, partitioner

    k, m, B, smax = 28, 10, 64, 64
    mesh = jax.make_mesh((4,), (exchange.AXIS,), devices=jax.devices("cpu")[:4])
    rng = np.random.default_rng(16)
    reads = random_reads(rng, 32, 120)
    codes = to_batch(reads, 120)
    owner_map = partitioner.hash_owner_map(B, 4)
    expect = dict(oracles.count_reads(reads, k))

    tables = {}
    for label, kw in (("sort", {}), ("ht", dict(use_ht=True))):
        step = exchange.build_distributed_count_smer(
            mesh, k, m, B, 512, smax, owner_map, **kw
        )
        sc = step(exchange.shard_batch(mesh, codes))
        assert int(sc.dropped) == 0 and int(sc.collision) == 0
        parts = exchange.compact_shard_counts(sc)
        words, counts, _bins = pipeline.merge_partials(parts, bits.num_words(k))
        kmers = bits.decode_words_batch(words, k)
        tables[label] = {km.decode(): int(c) for km, c in zip(kmers, counts.tolist())}
    assert tables["sort"] == expect
    assert tables["ht"] == expect
