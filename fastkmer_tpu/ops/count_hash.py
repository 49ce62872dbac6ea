"""Hash-based exact counting — the ``useHT=1`` engine.

The reference's HT path (``extractKXmersHT``,
SparkBinKmerCounter.scala:664-739) replaces sort+merge with a fastutil
``Object2IntOpenHashMap`` sized by the extraction-time upper bound.  A
probing hash table needs atomics and random access; this
re-interpretation keeps the *hash-based* idea —
compare 64-bit fingerprints instead of full k-mer keys — in a sort-friendly
form:

    sort by (validity, fp_hi, fp_lo)        # 3 keys regardless of W
    run totals over equal fingerprints (scan-only, tail-marked)
    verify: adjacent rows within a run have equal words (transitivity
    makes this equivalent to comparing against the run head, gather-free)

The verification makes exactness unconditional: a 64-bit fingerprint
collision (prob ~ N^2 / 2^64) raises ``FingerprintCollision`` and the
caller re-runs the batch with the sort engine.

PERFORMANCE: sorting 3 fingerprint keys instead of W word keys does not
shrink the sort, because the W word columns still ride as sort *values*
(the engine permutes W+4 lanes vs the sort engine's W).  This engine was
slower than the sort engine at every k on the previous accelerator; it is
not yet measured on the H100.  It exists for reference parity (useHT=1,
extractKXmersHT) and as the cross-engine exactness check; useHT=0 is the
default.

Both engines must produce identical count tables — the cross-engine
equality the reference relied on for validation (SURVEY.md §4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .count_sort import SortedCounts, _mark_and_count, _sort_sliced

_U = jnp.uint32


class FingerprintCollision(RuntimeError):
    """Two distinct k-mers shared a 64-bit fingerprint; re-run with the
    sort engine (astronomically rare)."""


def _mix32(h: jnp.ndarray) -> jnp.ndarray:
    # murmur3 finalizer
    h = h ^ (h >> _U(16))
    h = h * _U(0x85EBCA6B)
    h = h ^ (h >> _U(13))
    h = h * _U(0xC2B2AE35)
    return h ^ (h >> _U(16))


def fingerprint(words: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[N, W] uint32 -> (hi, lo) 64-bit fingerprint as two uint32 lanes."""
    N, W = words.shape
    if W == 1:
        return jnp.zeros(N, _U), words[:, 0]
    if W == 2:
        return words[:, 0], words[:, 1]  # k-mer IS the fingerprint
    hi = jnp.full(N, 0x9E3779B9, _U)
    lo = jnp.full(N, 0x85EBCA6B, _U)
    for w in range(W):
        x = words[:, w]
        hi = _mix32(hi ^ (x * _U(0xCC9E2D51)))
        lo = _mix32(lo + jnp.uint32(w + 1) * _U(0x27D4EB2F) ^ x)
    return hi, lo


def count_hashed(
    words: jnp.ndarray,
    bins: jnp.ndarray | None,
    valid: jnp.ndarray,
    weights: jnp.ndarray | None = None,
):
    """Like count_sort.count_sorted but keyed on 64-bit fingerprints.

    Returns (SortedCounts, collision_detected: bool scalar).  words in the
    result are run-head words (== each row's words when no collision).
    Output rows are in fingerprint order, NOT k-mer order — callers that
    need k-mer order (the writer) sort on host.

    ``bins`` is an optional carried column; pass None and recompute from
    the result words (ops.binhash.bins_from_words) to keep one column out
    of every sort pass — the returned SortedCounts.bins is then None.
    """
    N, W = words.shape
    hi, lo = fingerprint(words)
    flag = jnp.where(valid, _U(0), _U(1))
    w_in = jnp.ones(N, jnp.int32) if weights is None else weights.astype(jnp.int32)
    w_in = jnp.where(valid, w_in, 0)
    bcols = () if bins is None else (bins,)
    ops = (flag, hi, lo) + tuple(words[:, w] for w in range(W)) + bcols + (w_in,)
    # pow2 pad (count_sort._sort_sliced): flag=1 + all-ones fingerprint
    # pads sort last among invalids and slice back off losslessly
    fills = (
        (_U(1), _U(0xFFFFFFFF), _U(0xFFFFFFFF))
        + (_U(0xFFFFFFFF),) * W
        + (() if bins is None else (0,))
        + (0,)
    )
    out = _sort_sliced(ops, 3, fills)
    sflag, shi, slo = out[0], out[1], out[2]
    swords = out[3 : 3 + W]
    sbins = out[3 + W] if bins is not None else None
    sw = out[-1]
    svalid = sflag == _U(0)

    # runs are keyed on (validity flag, fingerprint); totals marked at run
    # tails, scan-only (see count_sort._mark_and_count)
    is_uniq, counts, n_valid = _mark_and_count([sflag, shi, slo], svalid, sw)

    # collision check WITHOUT the run-head gather: within a fingerprint run
    # all words equal the head's iff every ADJACENT pair is equal
    # (transitivity), so a shifted compare suffices
    neq_fp = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]) | (
        sflag[1:] != sflag[:-1]
    )
    same_run = ~jnp.concatenate([jnp.ones(1, bool), neq_fp])
    neq_words = jnp.zeros(N - 1, dtype=bool)
    for w in range(W):
        neq_words = neq_words | (swords[w][1:] != swords[w][:-1])
    mismatch = same_run & jnp.concatenate([jnp.zeros(1, bool), neq_words])
    collision = jnp.any(mismatch & svalid)

    sc = SortedCounts(
        words=jnp.stack(swords, axis=1),
        bins=sbins,
        is_uniq=is_uniq,
        counts=counts,
        n_valid=n_valid,
    )
    return sc, collision
