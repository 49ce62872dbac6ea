"""The stage-1 key path the accumulator feeds on (pipeline._batch_extract_keys,
and _batch_extract_keys_flagged for k % 16 == 0) against the dict oracle:
every window's pre-sentineled key row, and the counts that
count_presentineled derives from those rows."""

import numpy as np
import pytest

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch

KEY_CASES = [(28, 10), (13, 4), (31, 8), (17, 6), (33, 7), (55, 9), (64, 11),
             (75, 12), (97, 13), (128, 14)]
COUNT_CASES = [(28, 10), (13, 4), (45, 8), (75, 12), (97, 13)]
ONES = 0xFFFFFFFF


def _key_rows(codes, k, m, B):
    import jax.numpy as jnp

    from fastkmer_tpu import pipeline
    from fastkmer_tpu.ops import count_sort

    if count_sort.sentinel_safe_for(k):
        cols = pipeline._batch_extract_keys(jnp.asarray(codes), k, m, B)
    else:
        cols = pipeline._batch_extract_keys_flagged(jnp.asarray(codes), k, m, B)
    return cols, np.stack([np.asarray(c) for c in cols], axis=1)


@pytest.mark.parametrize("k,m", KEY_CASES)
def test_extract_keys_match_oracle(k, m):
    B = 128
    rng = np.random.default_rng(k)
    L = 96 if k <= 64 else 160  # rows must hold at least one window
    # fewer Ns at large k, so some windows stay clean
    reads = random_reads(rng, 12, L, n_prob=0.03 if k <= 33 else 0.003)
    _, rows = _key_rows(to_batch(reads, L), k, m, B)
    W = bits.num_words(k)
    flagged = k % 16 == 0
    assert rows.shape[1] == W + (1 if flagged else 0)
    P = L - k + 1
    n_clean = 0
    for r, read in enumerate(reads):
        for i in range(P):
            row = rows[r * P + i]
            window = read[i : i + k] if i + k <= len(read) else None
            if window is None or not all(c in "ACGT" for c in window):
                assert (row == ONES).all(), (r, i)
                continue
            n_clean += 1
            can = bits.encode_ascii(oracles.canonical(window))
            assert tuple(row[:W].tolist()) == bits.pack_kmer_words(can, k), (r, i)
            if flagged:
                assert row[W] == 0  # the constant-zero validity lane
    assert n_clean > 10


@pytest.mark.parametrize("k,m", COUNT_CASES)
def test_extract_keys_count_matches_oracle(k, m):
    """Sentinel-safe key columns + count_presentineled == the dict oracle."""
    from fastkmer_tpu.ops import count_sort

    B = 64
    rng = np.random.default_rng(k + 1)
    L = 80 if k <= 64 else 160
    reads = random_reads(rng, 10, L, n_prob=0.03 if k <= 33 else 0.003) * 2
    cols, _ = _key_rows(to_batch(reads, L), k, m, B)
    sc = count_sort.count_presentineled(list(cols))
    idx = np.flatnonzero(np.asarray(sc.is_uniq))
    kmers = bits.decode_words_batch(np.asarray(sc.words)[idx], k)
    got = {km.decode(): int(c) for km, c in zip(kmers, np.asarray(sc.counts)[idx].tolist())}
    expect = dict(oracles.count_reads(reads, k))
    assert got == expect
    assert int(sc.n_valid) == sum(expect.values())
