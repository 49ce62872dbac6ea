"""Sort-based exact counting (the reduce side, default engine).

Device re-design of the reference's sort path (``extractKXmers``,
SparkBinKmerCounter.scala:428-660): the reference expands super-k-mers into
(k,x)-mer run buckets, quicksorts each, and streams a heap-merge of shifted
scanners (RIndex / priorityQueueWithIndexes, package.scala:562-681).  All of
that machinery exists to enumerate k-mers in globally sorted order so equal
runs become counts.  On the device the same output semantics collapse to:

    lax.sort on (validity, word_0..word_{W-1}) keys
    run-boundary detection + run totals via forward scans only
    (_mark_and_count — no flips, no gathers)

with no scatter, no heap, no dynamic shapes.  Invalid entries carry a 1 in
the leading key word so they sort strictly after every real k-mer and can
never merge with an all-T k-mer (whose words can equal the sentinel).

The bin id rides along as a sort *value* (all equal k-mers share a bin since
the signature is a pure function of the k-mer string — SURVEY.md §0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


# Run totals are int32 scans (_mark_and_count): total weight per call must
# stay < 2^31.  Accumulators force a host spill when their conservative
# instance bound reaches this (2^27 of headroom below the wrap).
WEIGHT_LIMIT = (1 << 31) - (1 << 27)


class SortedCounts(NamedTuple):
    """Sorted unique-run view over N input slots.

    words:    [N, W] uint32 sorted k-mer words (valid first, then sentinels)
    bins:     [N]    int32 bin of each row
    is_uniq:  [N]    bool  True at ONE row per distinct valid k-mer (its run
                     TAIL — every row of a run carries the same words, so
                     selecting tails yields the unique table in sorted
                     order, and tail-marking makes the count epilogue
                     scan-only; see _mark_and_count)
    counts:   [N]    int32 the run's total, meaningful where is_uniq
    n_valid:  []     int32 total number of valid k-mer instances
    """

    words: jnp.ndarray
    bins: jnp.ndarray
    is_uniq: jnp.ndarray
    counts: jnp.ndarray
    n_valid: jnp.ndarray


def _mark_and_count(key_cols, svalid, sw=None):
    """Run totals from sorted key columns, marked at run TAILS.

    Returns (is_uniq, counts, n_valid).  Scan-only on purpose: the obvious
    head-marked formulation needs the NEXT boundary index (a suffix cummin
    = two jnp.flip passes) and, for weighted runs, a cumulative-weight
    lookup at that index (a random gather).  Tail-marking needs only the
    PREVIOUS boundary, which forward scans propagate: one cumsum (weights)
    + one cummax (head anchor), no flip/gather.

    Ranges: per-call total weight must stay < 2^31 (int32 scans) — callers
    bound merge fan-in accordingly, same contract as the int32 counts.
    """
    N = key_cols[0].shape[0]
    neq = key_cols[0][1:] != key_cols[0][:-1]
    for c in key_cols[1:]:
        neq = neq | (c[1:] != c[:-1])
    head = jnp.concatenate([jnp.ones(1, bool), neq])
    tail = jnp.concatenate([neq, jnp.ones(1, bool)])
    is_uniq = tail & svalid
    if sw is None:
        idx = jnp.arange(N, dtype=jnp.int32)
        hidx = jax.lax.cummax(jnp.where(head, idx, 0))  # idx of my run's head
        counts = jnp.where(is_uniq, idx - hidx + 1, 0)
        n_valid = jnp.sum(svalid.astype(jnp.int32))
    else:
        s = jnp.cumsum(sw)  # inclusive prefix of weights
        base = jax.lax.cummax(jnp.where(head, s - sw, 0))  # s at head-1
        counts = jnp.where(is_uniq, s - base, 0)
        n_valid = jnp.sum(sw)
    return is_uniq, counts, n_valid


def pow2_pad_rows(n: int, floor: int = 1 << 18, limit: float = 1.10) -> int:
    """Sentinel rows to append so a device sort runs at a power-of-two row
    count: lax.sort at pow2 sizes was cheaper per element on the previous
    accelerator (calibrated there; not yet measured on the H100).  0 when
    the next pow2 is further than ``limit`` away or the input is small."""
    if n < floor:
        return 0
    p2 = 1 << (n - 1).bit_length()
    return p2 - n if p2 <= n * limit else 0


def count_sorted(
    words: jnp.ndarray,
    bins: jnp.ndarray | None,
    valid: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    sentinel_safe: bool = False,
) -> SortedCounts:
    """words [N, W] uint32, valid [N] bool -> SortedCounts.

    ``bins`` ([N] int32) and ``weights`` ([N] int32) are OPTIONAL carried
    columns — every extra column is permuted by every pass of the device
    sort, so callers that can recompute bins from the unique words
    (ops.binhash.bins_from_words) or that count unweighted instances should
    pass None; the returned SortedCounts.bins is then None and counts are
    plain run lengths.

    ``weights`` generalizes instance counting to *merging* pre-counted
    partials: feeding back unique k-mers with their counts as weights sums
    counts per k-mer — used to combine batches and, across chips,
    all-to-all'd partial tables.

    ``sentinel_safe=True`` (valid when k % 16 != 0, i.e. the last word has
    zero pad bits) drops the leading validity key: invalid rows are rewritten
    to all-ones words, which no real k-mer can equal because its last word
    always has low zero bits.  One fewer sort key = one fewer permuted
    column per bitonic pass.
    """
    W = words.shape[1]
    ones = jnp.uint32(0xFFFFFFFF)
    values: list = []
    vfills: list = []
    if bins is not None:
        values.append(bins)
        vfills.append(0)
    if weights is not None:
        values.append(jnp.where(valid, weights.astype(jnp.int32), 0))
        vfills.append(0)
    if sentinel_safe:
        wcols = [jnp.where(valid, words[:, w], ones) for w in range(W)]
        out = _sort_sliced(
            tuple(wcols) + tuple(values), W, (ones,) * W + tuple(vfills)
        )
        swords = out[:W]
        svals = out[W:]
        svalid = swords[W - 1] != jnp.uint32(0xFFFFFFFF)
    else:
        flag = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        keys = [flag] + [words[:, w] for w in range(W)]
        out = _sort_sliced(
            tuple(keys) + tuple(values), W + 1,
            (jnp.uint32(1),) + (ones,) * W + tuple(vfills),
        )
        swords = out[1 : W + 1]
        svals = out[W + 1 :]
        svalid = out[0] == jnp.uint32(0)
    sbins = svals[0] if bins is not None else None
    sw = svals[-1] if weights is not None else None

    # run boundaries over (validity, words): in the flag path the flag is a
    # genuine leading key (identically-worded valid/invalid rows — the all-T
    # case — must not merge); in the sentinel path the rewrite already
    # separates them
    key_cols = list(swords) if sentinel_safe else [out[0], *swords]
    is_uniq, counts, n_valid = _mark_and_count(key_cols, svalid, sw)

    return SortedCounts(
        words=jnp.stack(swords, axis=1),
        bins=sbins,
        is_uniq=is_uniq,
        counts=counts,
        n_valid=n_valid,
    )


def _sort_sliced(ops: tuple, num_keys: int, fills: tuple):
    """lax.sort with transparent pow2 padding (pow2_pad_rows): append
    sentinel rows whose keys sort LAST (per-operand ``fills``), sort,
    slice back to the input length.  Valid rows sort to the front, so the
    first N rows of the padded sort equal the unpadded sort's output
    exactly (trailing sentinel/invalid rows are interchangeable — every
    caller gives them zero weight / False validity)."""
    N = ops[0].shape[0]
    pad = pow2_pad_rows(N)
    if pad:
        ops = tuple(
            jnp.concatenate([o, jnp.full(pad, f, o.dtype)])
            for o, f in zip(ops, fills)
        )
    out = jax.lax.sort(ops, num_keys=num_keys, is_stable=False)
    if pad:
        out = tuple(o[:N] for o in out)
    return out


def count_presentineled(cols: list, weights: jnp.ndarray | None = None) -> SortedCounts:
    """Count from pre-sentineled key columns (invalid rows already all-ones,
    e.g. from pipeline._batch_extract_keys or accumulator merge rows): sorts the bare keys and derives validity from the sentinel
    — zero pre-sort rewrites.  ``weights`` (int32, already 0 on sentinel
    rows) turns run-length counting into weighted merging.  bins in the
    result are None."""
    W = len(cols)
    ops = tuple(cols) + (() if weights is None else (weights,))
    fills = (jnp.uint32(0xFFFFFFFF),) * W + (() if weights is None else (0,))
    out = _sort_sliced(ops, W, fills)
    swords = out[:W]
    svalid = swords[W - 1] != jnp.uint32(0xFFFFFFFF)

    is_uniq, counts, n_valid = _mark_and_count(
        list(swords), svalid, None if weights is None else out[W]
    )

    return SortedCounts(
        words=jnp.stack(swords, axis=1),
        bins=None,
        is_uniq=is_uniq,
        counts=counts,
        n_valid=n_valid,
    )


def compact_marked(
    cols: tuple,
    counts: jnp.ndarray,
    is_uniq: jnp.ndarray,
    out_cap: int,
    block: int = 8192,
):
    """Compact the marker rows of a SORTED run view to the front, in order,
    at fixed capacity.

    Returns (cols_out tuple of [out_cap], counts_out [out_cap], n_u scalar,
    overflow scalar) — rows past n_u are sentinel/0; uniques beyond out_cap
    are dropped and counted in ``overflow``.

    Not a global sort: non-marker rows are rewritten to the all-ones
    sentinel, then each BLOCK of rows is sorted locally — the input is
    globally sorted, so blocks are in global order and a block-local sort
    pushes its live rows to the block front still in global order, at
    log2(block)^2 comparator stages instead of log2(N)^2.  Block prefixes
    are stitched with a lax.scan of dynamic_update_slice at cumulative
    offsets (each block writes its full width; the next block's write
    starts exactly after this block's live prefix, overwriting the sentinel
    tail).

    Requires the sentinel to sort after every live row (sentinel-safe keys,
    or a trailing lane that is never all-ones on live rows).
    """
    N = cols[0].shape[0]
    W = len(cols)
    block = min(block, N)
    assert N % block == 0, (N, block)
    nb = N // block
    ones = jnp.uint32(0xFFFFFFFF)
    ccols = [jnp.where(is_uniq, c, ones) for c in cols]
    cnts = jnp.where(is_uniq, counts, 0)
    blocked = jax.lax.sort(
        tuple(c.reshape(nb, block) for c in ccols) + (cnts.reshape(nb, block),),
        dimension=1,
        num_keys=W,
        is_stable=False,
    )
    live = blocked[W - 1] != ones  # [nb, block]
    h = jnp.sum(live.astype(jnp.int32), axis=1)
    n_u = jnp.sum(h)
    off = jnp.minimum(jnp.cumsum(h) - h, jnp.int32(out_cap))
    init = tuple(jnp.full(out_cap + block, ones, jnp.uint32) for _ in range(W)) + (
        jnp.zeros(out_cap + block, jnp.int32),
    )
    # under shard_map the data is varying over the mesh axes while these
    # fresh constants are not — the scan carry must agree, so mark them
    vma = getattr(getattr(cols[0], "aval", None), "vma", frozenset())
    if vma:
        init = tuple(
            jax.lax.pcast(a, tuple(vma), to="varying") for a in init
        )

    def body(carry, x):
        *blocks, o = x
        return (
            tuple(
                jax.lax.dynamic_update_slice(carry[i], blocks[i], (o,))
                for i in range(W + 1)
            ),
            None,
        )

    out, _ = jax.lax.scan(body, init, tuple(blocked) + (off,))
    return (
        tuple(out[w][:out_cap] for w in range(W)),
        out[W][:out_cap],
        n_u,
        jnp.maximum(n_u - out_cap, 0),
    )


def sentinel_safe_for(k: int) -> bool:
    """True when the last packed word has zero pad bits (k % 16 != 0), so
    the all-ones sentinel cannot collide with any real k-mer."""
    return k % 16 != 0


def bin_histogram(bins: jnp.ndarray, valid: jnp.ndarray, B: int) -> jnp.ndarray:
    """Per-bin k-mer instance counts — the array form of the reference's
    sampled estimate pre-pass (``getBinsEstimateSizes``,
    SparkBinKmerCounter.scala:172-288) and of the binSizes upper bound used
    to size hash tables (:290-426)."""
    return jnp.bincount(
        jnp.where(valid, bins, B), weights=None, length=B + 1
    )[:B].astype(jnp.int32)
