"""Randomized cross-config fuzz: for a sweep of (k, m) covering every word
-boundary regime, both engines must agree with the dict oracle on random
N-ridden reads."""

import numpy as np
import pytest

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch

CONFIGS = [
    (15, 4), (16, 15), (17, 5), (24, 12), (31, 10), (32, 10),
    (33, 14), (47, 8), (48, 6), (49, 13), (64, 10),
    # W > 4
    (75, 10), (97, 12),
    # k > 128 (W > 8): past the native merge's packed-key fast paths — the
    # reference Kmer is arbitrary-length (package.scala:138-503)
    (129, 12), (155, 10), (201, 14),
]


@pytest.mark.parametrize("k,m", CONFIGS)
def test_fuzz_all_paths_agree(k, m):
    import jax
    import jax.numpy as jnp

    from fastkmer_tpu.ops import count_hash, count_sort
    from fastkmer_tpu.ops import extract as jex

    B = 64
    rng = np.random.default_rng(1000 + k * 16 + m)
    L = max(2 * k, 80)
    reads = random_reads(rng, 8, L)
    codes = to_batch(reads, L)
    jc = jnp.asarray(codes)
    expect = dict(oracles.count_reads(reads, k))

    def table_from(sc):
        idx = np.flatnonzero(np.asarray(sc.is_uniq))
        kmers = bits.decode_words_batch(np.asarray(sc.words)[idx], k)
        return {
            km.decode(): int(c)
            for km, c in zip(kmers, np.asarray(sc.counts)[idx].tolist())
        }

    ex = jax.jit(lambda c: jex.extract(c, k, m, B))(jc)

    # sort engine (flag or sentinel key depending on k)
    sc = count_sort.count_sorted(
        ex.words, None, ex.valid, sentinel_safe=count_sort.sentinel_safe_for(k)
    )
    assert table_from(sc) == expect, f"sort engine mismatch k={k} m={m}"

    # HT engine
    sc_ht, collision = count_hash.count_hashed(ex.words, ex.bins, ex.valid)
    assert not bool(collision)
    ht_idx = np.flatnonzero(np.asarray(sc_ht.is_uniq))
    ht_kmers = bits.decode_words_batch(np.asarray(sc_ht.words)[ht_idx], k)
    ht = {
        km.decode(): int(c)
        for km, c in zip(ht_kmers, np.asarray(sc_ht.counts)[ht_idx].tolist())
    }
    assert ht == expect, f"HT engine mismatch k={k} m={m}"


def skewed_reads(rng, n, L):
    """Realistic-skew composition: homopolymer stretches, tandem repeats,
    low-complexity di-nucleotide runs, palindromic stretches — the inputs
    where run-length counting, RC canonicalization ties, and minimizer
    skew actually get exercised (uniform random is the EASY case for all
    three)."""
    unit = "".join(rng.choice(list("ACGT"), size=7))
    reads = []
    for _ in range(n):
        parts = []
        ln = 0
        while ln < L - 10:
            kind = rng.integers(0, 5)
            if kind == 0:  # homopolymer
                seg = rng.choice(list("ACGT")) * int(rng.integers(8, 40))
            elif kind == 1:  # tandem repeat
                seg = unit * int(rng.integers(2, 8))
            elif kind == 2:  # dinucleotide low-complexity
                seg = "".join(rng.choice(["AT", "CG", "TA"])) * int(rng.integers(5, 20))
            elif kind == 3:  # random
                seg = "".join(rng.choice(list("ACGT"), size=int(rng.integers(10, 30))))
            else:  # RC palindrome (fwd + its reverse complement)
                h = "".join(rng.choice(list("ACGT"), size=int(rng.integers(5, 14))))
                seg = h + h[::-1].translate(str.maketrans("ACGT", "TGCA"))
            parts.append(seg)
            ln += len(seg)
        reads.append("".join(parts)[:L])
    return reads


@pytest.mark.parametrize("k,m", [(28, 10), (16, 7), (31, 9), (75, 10)])
def test_fuzz_skewed_composition(k, m):
    """Repeat-rich / homopolymer-heavy reads (high counts, few uniques,
    minimizer skew) must match the oracle through the full single-chip
    path AND the 8-device streaming exchange."""
    import jax
    import jax.numpy as jnp

    from fastkmer_tpu.ops import count_sort
    from fastkmer_tpu.ops import extract as jex

    B = 64
    rng = np.random.default_rng(4000 + k)
    L = max(2 * k, 120)
    reads = skewed_reads(rng, 8, L)
    codes = to_batch(reads, L)
    expect = dict(oracles.count_reads(reads, k))

    ex = jax.jit(lambda c: jex.extract(c, k, m, B))(jnp.asarray(codes))
    sc = count_sort.count_sorted(
        ex.words, None, ex.valid, sentinel_safe=count_sort.sentinel_safe_for(k)
    )
    idx = np.flatnonzero(np.asarray(sc.is_uniq))
    kmers = bits.decode_words_batch(np.asarray(sc.words)[idx], k)
    got = {
        km.decode(): int(c)
        for km, c in zip(kmers, np.asarray(sc.counts)[idx].tolist())
    }
    assert got == expect, f"skewed composition mismatch k={k} m={m}"
    # skew sanity: the composition must actually produce heavy counts
    # (only checkable when k fits inside the repeat/homopolymer scale)
    if expect and k <= 32:
        assert max(expect.values()) >= 5

    if k % 16 != 0:
        import jax as _jax

        from fastkmer_tpu.parallel import exchange, partitioner, stream

        mesh = _jax.make_mesh((8,), (exchange.AXIS,), devices=_jax.devices("cpu")[:8])
        ctr = stream.DistributedCounter(
            mesh, k, m, B, cap=L * 8, acc_cap=1 << 14,
            owner_map=partitioner.hash_owner_map(B, 8), fanin=2,
        )
        ctr.feed(codes)
        words, counts, bins = ctr.finalize()
        dk = bits.decode_words_batch(words, k)
        dist = {km.decode(): int(c) for km, c in zip(dk, counts.tolist())}
        assert dist == expect, f"streaming skew mismatch k={k} m={m}"
