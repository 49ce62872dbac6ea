"""Job orchestration — the device equivalent of ``executeJob``
(reference: SparkBinKmerCounter.scala:989-1046).

The Spark plan  ``mapPartitions(getSuperKmers) -> reduceByKey(shuffle) ->
foreachPartition(extractKXmers)``  becomes:

    host ingest -> fixed-shape code batches
      -> jit[ stage-1 extract + per-batch sort-count ]      (device)
      -> host compaction of per-batch unique partials
      -> final weighted merge                               (device or host)
      -> per-bin text/binary output                         (host)

Single-chip path here; the multi-chip path (shard_map + all-to-all bin
exchange, replacing the Spark shuffle) lives in ``parallel.exchange`` and is
driven by ``execute_job`` when a mesh is provided.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, NamedTuple

import os

import jax
import jax.numpy as jnp
import numpy as np

from .config import JobConfig
from .core.bits import num_words
from .ingest import batch as batching
from .ops import count_sort, extract
from .output import writer
from .utils.timing import StageTimer
from .utils import jaxcache  # noqa: F401  (enables persistent XLA cache)


class CountResult(NamedTuple):
    words: np.ndarray  # [U, W] uint32 unique canonical k-mers, ascending
    counts: np.ndarray  # [U] int64
    bins: np.ndarray  # [U] int32
    n_instances: int  # total counted k-mer instances
    n_bases: int
    n_reads: int
    timings: dict


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_count(codes: jnp.ndarray, k: int, m: int, B: int) -> count_sort.SortedCounts:
    """One fused device step: extract all windows, sort, run-length count.

    The sort carries ONLY the key words (no bin/weight lanes) — bins are
    recomputed from the sorted words afterwards (ops.binhash), which costs
    elementwise work instead of a permuted column per sort pass.
    """
    from .ops import binhash

    ex = extract.extract(codes, k, m, B)
    sc = count_sort.count_sorted(
        ex.words, None, ex.valid, sentinel_safe=count_sort.sentinel_safe_for(k)
    )
    return sc._replace(bins=binhash.bins_from_words(sc.words, k, m, B))


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_count_ht(codes: jnp.ndarray, coll_in: jnp.ndarray, k: int, m: int, B: int):
    """HT-engine device step (useHT=1): fingerprint-keyed counting.

    The collision flag is ACCUMULATED on device (coll_in | batch collision)
    and checked once at finalize — a per-batch bool() pull would cost a
    full device round trip per step (collisions exist to be astronomically
    rare).  Bins ride no sort lane; they are recomputed from the run-head
    words (ops.binhash)."""
    from .ops import binhash, count_hash

    ex = extract.extract(codes, k, m, B)
    sc, coll = count_hash.count_hashed(ex.words, None, ex.valid)
    sc = sc._replace(bins=binhash.bins_from_words(sc.words, k, m, B))
    return sc, coll_in | coll


@partial(jax.jit, static_argnames=())
def _to_merge_rows(sc: count_sort.SortedCounts):
    """SortedCounts -> (word cols, weights) in 'merge row' form: unique rows
    keep their words + total count, all other rows become sentinel/0."""
    W = sc.words.shape[1]
    ones = jnp.uint32(0xFFFFFFFF)
    cols = tuple(jnp.where(sc.is_uniq, sc.words[:, w], ones) for w in range(W))
    return cols, jnp.where(sc.is_uniq, sc.counts, 0)


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_extract_keys(codes: jnp.ndarray, k: int, m: int, B: int):
    """Stage-1 only: pre-sentineled sort-key columns, NO per-batch sort —
    the accumulator defers all sorting to its fan-in merge, which costs
    ~half the comparator work of sort-per-batch + re-sort-at-merge."""
    ex = extract.extract(codes, k, m, B)
    ones = jnp.uint32(0xFFFFFFFF)
    W = ex.words.shape[1]
    return tuple(jnp.where(ex.valid, ex.words[:, w], ones) for w in range(W))


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_extract_keys_flagged(codes: jnp.ndarray, k: int, m: int, B: int):
    """k % 16 == 0 variant: the all-ones sentinel is ambiguous (an all-T
    k-mer's words equal it), so a constant-ZERO trailing lane makes valid
    rows sentinel-safe again — 0 on valid rows, all-ones on invalid (the
    multiseq seq-lane trick with a degenerate id).  One extra lane in every
    merge sort buys the deferred accumulator for every k."""
    ex = extract.extract(codes, k, m, B)
    ones = jnp.uint32(0xFFFFFFFF)
    W = ex.words.shape[1]
    cols = tuple(jnp.where(ex.valid, ex.words[:, w], ones) for w in range(W))
    return cols + (jnp.where(ex.valid, jnp.uint32(0), ones),)


@jax.jit
def _pack_stats(n_unique, overflow):
    return jnp.stack([n_unique.astype(jnp.int32), overflow.astype(jnp.int32)])


@partial(jax.jit, static_argnames=("k", "m", "B", "cap"))
def _batch_count_dedup(codes: jnp.ndarray, k: int, m: int, B: int, cap: int):
    """Pre-dedup device step for DUP-HEAVY inputs: per-batch count, then
    compact the unique rows to ``cap`` (count_sort.compact_marked) so the
    accumulator merges cap rows instead of all positions — the reference's
    (k,x)-mer run compression re-landed on the device
    (SparkBinKmerCounter.scala:467-525).  Worth it only when the in-batch
    distinct ratio is well under cap/positions (count_batches probes and
    switches adaptively).

    Returns (ccols, wts, n_u, over, raw_cols): per-BATCH unique count and
    compaction overflow scalars, plus the PRE-SORT extracted key columns.
    The caller prefetches the scalars without blocking and, when ``over``
    lands nonzero, falls back to re-feeding THAT batch raw (lossless — an
    input whose duplication ratio flips right after a probe can exceed
    the cap, and dropping its uniques or aborting the run would make the
    adaptive default unsafe on oscillating inputs).  ``raw_cols`` makes
    that fallback free of a second extraction pass: the overflow path
    admits the already-extracted columns directly (an extra W·npos·4 B of
    HBM output traffic — trivial next to the sort — in exchange for
    halving the cost of a failed probe)."""
    cols = _batch_extract_keys(codes, k, m, B)
    N = cols[0].shape[0]
    pad = -N % (1 << 16)  # compact block granularity
    pcols = cols
    if pad:
        ones = jnp.uint32(0xFFFFFFFF)
        pcols = tuple(jnp.concatenate([c, jnp.full(pad, ones, jnp.uint32)]) for c in cols)
    sc = count_sort.count_presentineled(list(pcols))
    ccols, wts, n_u, over = count_sort.compact_marked(
        tuple(sc.words[:, w] for w in range(sc.words.shape[1])),
        sc.counts, sc.is_uniq, cap,
    )
    return ccols, wts, n_u, over, cols


@partial(jax.jit, static_argnames=("acc_cap", "lanes"))
def _init_acc_state(acc_cap: int, lanes: int):
    cols = tuple(
        jnp.full(acc_cap, 0xFFFFFFFF, jnp.uint32) for _ in range(lanes)
    )
    return (cols, jnp.zeros(acc_cap, jnp.int32), jnp.int32(0), jnp.int32(0))


def _acc_merge(parts, acc):
    """One fused weighted merge: (raw/counted parts, accumulator) -> new
    accumulator at fixed capacity.

    parts: tuple of (cols tuple, wts | None) — None means raw k-mer
    instances (weight 1 where non-sentinel), arrays mean pre-counted
    uniques.  acc: (cols, wts, n_unique, overflow).  Inputs are padded to
    a 64Ki granule so the compile set stays bounded; the merge is ONE
    weighted count sort + scan-only run totals + block compaction.
    """
    acc_cols, acc_wts, _acc_nu, acc_over = acc
    W = len(acc_cols)
    acc_cap = acc_cols[0].shape[0]
    ones = jnp.uint32(0xFFFFFFFF)
    n_rows = sum(p[0][0].shape[0] for p in parts) + acc_cap
    # round to 64Ki granules: bounded compile set without power-of-two
    # memory blowup (a pow2 round of 8 batches + acc nearly doubles HBM).
    # EXCEPT when a pow2 is within 10%: the sort was cheaper per element
    # at a pow2 row count on the previous accelerator (not yet measured on
    # the H100), so the accumulator's merge trigger aims for near-pow2
    # totals (DeviceAccumulator._append) and the merge pads the rest
    cap_in = -(-n_rows // (1 << 16)) * (1 << 16)
    p2 = 1 << (n_rows - 1).bit_length()
    if p2 <= n_rows * 1.10:
        cap_in = max(cap_in, p2)
    pad = cap_in - n_rows
    mcols = []
    for w in range(W):
        segs = [p[0][w] for p in parts] + [acc_cols[w]]
        if pad:
            segs.append(jnp.full(pad, ones, jnp.uint32))
        mcols.append(jnp.concatenate(segs))
    wsegs = []
    for cols_p, wts_p in parts:
        if wts_p is None:
            wsegs.append((cols_p[W - 1] != ones).astype(jnp.int32))
        else:
            wsegs.append(wts_p)
    wsegs.append(acc_wts)
    if pad:
        wsegs.append(jnp.zeros(pad, jnp.int32))
    wts = jnp.concatenate(wsegs)
    # all inputs are pre-sentineled with zero weights on sentinel rows —
    # skip count_sorted's validity rewrite pass entirely
    sc = count_sort.count_presentineled(mcols, weights=wts)
    # compaction to acc_cap: block-local sorts + scan placement — never a
    # global sort (7x dearer at this width), never a gather/scatter
    # (count_sort.compact_marked; sentinel-safety is guaranteed on this
    # path by the sentinel_safe_for(k) / extra-lane gate)
    new_cols, new_wts, n_u, over = count_sort.compact_marked(
        tuple(sc.words[:, w] for w in range(W)), sc.counts, sc.is_uniq, acc_cap,
        block=1 << 15,
    )
    return (new_cols, new_wts, jnp.minimum(n_u, acc_cap), acc_over + over)


# One shared jit wrapper (per-instance wrappers would re-trace every merge
# variant per DeviceAccumulator).  Donate only the accumulator: part
# buffers never alias any output shape.
_MERGE_JIT = jax.jit(_acc_merge, donate_argnums=(1,))


# Device run totals are int32 scans (count_sort._mark_and_count): the total
# weight resident on device must stay < 2^31 per merge.  Accumulators force
# a host spill when the conservative instance bound approaches it, so
# >2 Gbp of identical k-mers can never wrap silently.
_WT_LIMIT = count_sort.WEIGHT_LIMIT


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _stack_with_bins(cols: tuple, wts: jnp.ndarray, k: int, m: int, B: int) -> jnp.ndarray:
    """[cap] cols + weights -> one [cap, lanes+2] uint32 matrix (key lanes,
    count, bin) so the host pull is a single contiguous transfer.  Bins are
    a function of the k-mer words only — any trailing lanes (multiseq seq
    id) are carried but excluded from the hash."""
    from .ops import binhash

    words = jnp.stack(cols, axis=1)
    bins = binhash.bins_from_words(words[:, : num_words(k)], k, m, B)
    return jnp.concatenate(
        [words, wts.astype(jnp.uint32)[:, None], bins.astype(jnp.uint32)[:, None]], axis=1
    )


class DeviceAccumulator:
    """Device-resident cross-batch merging with deferred sorting.

    The Spark reference merges partials through the JVM shuffle; the naive
    device translation (pull every batch's table to the host, numpy-merge
    at the end) moves every batch's table over the host link.  This
    accumulator buffers RAW pre-sentineled key columns
    per batch (``add_raw`` — no per-batch sort at all), merges every
    ``fanin`` batches with ONE weighted count-sort + block compaction
    (count_sort.compact_marked) into a FIXED-capacity unique table, and pulls one stacked
    (words, count, bin) matrix at the end.  When the distinct count
    outgrows ``acc_cap`` it spills the table to the host at a merge
    boundary, so any dataset fits in a fixed device budget.

    No per-merge host sync: capacity pressure is tracked with conservative
    host-side upper bounds, refreshed OPPORTUNISTICALLY from the prefetched
    stats of past merges (``jax.Array.is_ready`` — zero blocking) and by a
    blocking scalar pull only when a spill decision is actually needed;
    genuine overflow is recorded by a device counter and raised at finalize.

    ``unique_ub`` — a caller-asserted upper bound on TOTAL distinct keys
    (e.g. genome length: distinct canonical k-mers <= positions) — sizes the
    table once and disables all host-side room checks: the feed loop then
    dispatches with ZERO device round trips and one fence at the end.  The
    assertion is verified, not trusted: the device overflow counter still
    raises at finalize if it was wrong.
    """

    # pending-buffer HBM budget backing the max_device_rows default: at
    # W=2 (k<=32) it admits 192M buffered rows, the best merge cadence with
    # fanin=16 on the previous accelerator (calibrated there; not yet
    # measured on the H100).  Larger W scales the row bound down so k=97
    # (8 lanes) cannot pin 6+ GB of pending columns
    PENDING_BYTE_BUDGET = 1_536_000_000

    def __init__(
        self,
        k: int,
        fanin: int = 16,
        max_device_rows: int | None = None,
        m: int = 10,
        B: int = 512,
        acc_cap: int | None = None,
        unique_ub: int | None = None,
        extra_lanes: int = 0,
    ):
        self.k = k
        self.W = num_words(k)  # k-mer key words (the binhash input)
        # total sort lanes: extra trailing key lanes (e.g. multiseq's
        # sequence id) ride every merge; valid rows never carry the all-ones
        # value in them, so the sentinel stays collision-free for ANY k
        self.lanes = self.W + extra_lanes
        self.m = m
        self.B = B
        self.fanin = fanin
        if max_device_rows is None:
            max_device_rows = self.PENDING_BYTE_BUDGET // (4 * self.lanes)
        self.max_device_rows = max_device_rows
        if unique_ub is not None and acc_cap is None:
            # next 64Ki granule + 2 granules of slack, floor 2^14.  The
            # slack is deliberately SMALL (not a % headroom): the bound is
            # verified at finalize, and a tight cap lets the pow2 merge
            # trigger fire (7 batches + cap ~= 2^27; _append)
            acc_cap = max(
                1 << 14, (-(-int(unique_ub) // (1 << 16)) + 2) * (1 << 16)
            )
        self.acc_cap = acc_cap  # sized from the first part when None
        self.assume_fits = unique_ub is not None
        self.state = None  # (cols tuple [acc_cap], wts, n_unique [], overflow [])
        self.pending: list = []  # (cols tuple, wts | None)
        self.rows = 0  # pending buffered rows
        self._acc_ub = 0  # conservative bound on accumulated uniques
        self._pend_ub = 0  # conservative bound on pending new uniques
        self._cum_merged = 0  # conservative total uniques ever merged in
        self._wt_dev = 0  # bound on total instance weight on device
        self._merge_log: list = []  # (stats_arr, _cum_merged at that merge)
        self.host_spills: list = []  # (words, counts, bins) np arrays
        self._merge = _MERGE_JIT  # shared across instances: one trace cache

    def _init_state(self):
        # built ON DEVICE: a host device_put of the sentinel padding ships
        # acc_cap*(lanes+1)*4 bytes over the host link for no reason
        return _init_acc_state(self.acc_cap, self.lanes)

    def add_raw(self, cols: tuple) -> None:
        """Buffer one batch of pre-sentineled key columns (weight 1 each)."""
        self._append((tuple(cols), None), int(cols[0].shape[0]))

    def add(self, sc: count_sort.SortedCounts) -> None:
        """Buffer one pre-counted batch (unique rows weighted by count)."""
        cols, wts = _to_merge_rows(sc)
        self._append((cols, wts), int(wts.shape[0]))

    def add_part(self, cols: tuple, wts: jnp.ndarray) -> None:
        """Buffer one pre-counted COMPACTED part (e.g. _batch_count_dedup
        output): unique rows at the front, sentinel/0 tail."""
        self._append((tuple(cols), wts), int(wts.shape[0]))

    def _append(self, part, n_new_ub: int) -> None:
        if self.acc_cap is None:
            self.acc_cap = 1 << max(14, (2 * n_new_ub - 1).bit_length())
        if self.state is None:
            self.state = self._init_state()
            self._stats_arr = None
        if self._wt_dev + n_new_ub > _WT_LIMIT:
            # int32 run-total wrap guard (see _WT_LIMIT) — applies even
            # under assume_fits: it bounds weights, not capacity
            self._merge_pending()
            stats = self._stats()
            self._raise_if_lost(stats)
            self._spill(stats)
        if len(self.pending) >= max(2, self.fanin - 2):
            # pow2 merge scheduling: when the buffered rows + accumulator
            # sit just under a power of two and this part would cross it,
            # merge NOW — the sort was cheaper per element at a pow2 row
            # count on the previous accelerator (not yet measured on the
            # H100; _acc_merge pads the <=10% remainder).  Gated on a near-full window so the pow2 bonus never trades
            # away fan-in amortization (merging early re-sorts the
            # accumulator more often, which costs more than it saves)
            cur = self.rows + self.acc_cap
            p2 = 1 << (cur - 1).bit_length()
            if p2 <= cur * 1.10 and cur + int(part[0][0].shape[0]) > p2:
                self._merge_pending()
        self._ensure_room(n_new_ub)
        self.pending.append(part)
        self.rows += int(part[0][0].shape[0])
        self._pend_ub += n_new_ub
        self._wt_dev += n_new_ub
        if len(self.pending) >= self.fanin or self.rows > self.max_device_rows:
            self._merge_pending()

    def _merge_pending(self) -> None:
        if not self.pending:
            return
        self.state = self._merge(tuple(self.pending), self.state)
        self.pending = []
        self.rows = 0
        self._acc_ub = min(self._acc_ub + self._pend_ub, self.acc_cap)
        self._cum_merged += self._pend_ub
        self._pend_ub = 0
        # pack the scalars and start the D2H copy NOW: by the time the host
        # needs them for a spill decision the transfer has already landed
        self._stats_arr = _pack_stats(self.state[2], self.state[3])
        self._stats_arr.copy_to_host_async()
        self._merge_log.append((self._stats_arr, self._cum_merged))
        del self._merge_log[:-8]

    def _refresh_landed(self) -> None:
        """Tighten _acc_ub from the newest ALREADY-LANDED merge stats —
        never blocks.  n_unique measured at merge j plus the conservative
        uniques merged after j is a valid upper bound on the table now."""
        for arr, cum_at in reversed(self._merge_log):
            if arr.is_ready():
                vals = np.asarray(arr)
                self._acc_ub = min(
                    self._acc_ub, int(vals[0]) + (self._cum_merged - cum_at)
                )
                if vals[1]:
                    self._raise_if_lost({"overflow": int(vals[1])})
                return

    def _ensure_room(self, incoming: int) -> None:
        if self.assume_fits:
            return  # caller asserted total uniques <= acc_cap; finalize verifies
        if self._acc_ub + self._pend_ub + incoming <= self.acc_cap:
            return
        self._refresh_landed()  # free tightening from prefetched stats
        if self._acc_ub + self._pend_ub + incoming <= self.acc_cap:
            return
        stats = self._stats()  # exact occupancy before deciding to spill
        self._acc_ub = stats["n_unique"]
        while self._acc_ub + self._pend_ub + incoming > self.acc_cap:
            if self.pending:
                # merge first: duplicates may collapse the conservative
                # pending bound far below acc_cap (no spill needed at all)
                self._merge_pending()
                stats = self._stats()
                self._acc_ub = stats["n_unique"]
            elif self._acc_ub > 0:
                self._raise_if_lost(stats)
                self._spill(stats)
            else:
                # a single batch exceeds acc_cap: the device overflow
                # counter records the loss and finalize raises
                break

    def _stats(self) -> dict:
        if self.state is None:
            return {"n_unique": 0, "overflow": 0}
        arr = getattr(self, "_stats_arr", None)
        if arr is None:
            arr = _pack_stats(self.state[2], self.state[3])
        vals = np.asarray(arr)  # ONE transfer (usually already prefetched)
        return {"n_unique": int(vals[0]), "overflow": int(vals[1])}

    def _raise_if_lost(self, stats: dict) -> None:
        if stats["overflow"]:
            raise RuntimeError(
                f"accumulator overflow: {stats['overflow']} uniques lost; "
                f"raise acc_cap (= {self.acc_cap})"
            )

    def _spill(self, stats: dict) -> None:
        """Spill the accumulated table — ASYNCHRONOUSLY: the device slice is
        appended to host_spills with its D2H copy merely STARTED, so the
        feed keeps dispatching while the table streams out (a synchronous
        pull stalls the pipeline for the whole transfer — seconds per spill
        at production sizes).  Entries are converted to numpy lazily:
        opportunistically once landed (freeing the device buffer), and
        forcibly before checkpoint persistence or finalize
        (materialize_spills)."""
        n_u = stats["n_unique"]
        if n_u:
            cols, wts, _, _ = self.state
            stacked = _stack_with_bins(cols, wts, self.k, self.m, self.B)
            sl = stacked[:n_u]
            sl.copy_to_host_async()
            self.host_spills.append(sl)
        self.state = self._init_state()
        self._stats_arr = None
        self._acc_ub = 0
        self._wt_dev = 0  # spilled weights left the device (pending is empty)
        self._merge_log = []  # old-table stats bound nothing anymore
        self.materialize_spills(block=False)  # free any landed older spills
        self._bound_inflight()

    def _to_np_spill(self, arr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        table = np.asarray(arr)
        return (
            table[:, : self.lanes],
            table[:, self.lanes].astype(np.int64),
            table[:, self.lanes + 1].astype(np.int32),
        )

    def materialize_spills(self, block: bool = True) -> None:
        """Convert pending device-side spills to numpy tuples.  block=False
        converts only ALREADY-LANDED transfers (never waits); block=True
        waits for all — required before persisting spills to a checkpoint
        (a crash must not lose a spill that only existed on device)."""
        for i, s in enumerate(self.host_spills):
            if isinstance(s, tuple):
                continue
            if not block and not s.is_ready():
                continue
            self.host_spills[i] = self._to_np_spill(s)

    # at most this many spills may be in flight (device buffers alive with
    # their D2H copies unlanded) — unbounded pending spills would pin
    # acc_cap-row buffers in HBM faster than a slow link drains them.  The
    # bound is enforced POST-APPEND, inside each spill: a spill may
    # transiently observe MAX+1 pending entries while _bound_inflight
    # materializes the oldest, and the invariant holds again when the
    # spill returns (the observation point tests assert at — ADVICE r3)
    MAX_INFLIGHT_SPILLS = 2

    def _bound_inflight(self) -> None:
        """Force-materialize oldest pending spills (FIFO transfer order)
        until at most MAX_INFLIGHT_SPILLS device buffers remain alive."""
        pend = [i for i, s in enumerate(self.host_spills)
                if not isinstance(s, tuple)]
        for i in pend[: max(0, len(pend) - self.MAX_INFLIGHT_SPILLS)]:
            self.host_spills[i] = self._to_np_spill(self.host_spills[i])

    def finalize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (unique words [U, W] ascending, counts [U], bins [U]) on host."""
        self._merge_pending()
        stats = self._stats()
        self._raise_if_lost(stats)
        self._spill(stats)
        self.materialize_spills(block=True)
        if not self.host_spills:
            return (
                np.zeros((0, self.lanes), np.uint32),
                np.zeros(0, np.int64),
                np.zeros(0, np.int32),
            )
        if len(self.host_spills) == 1:
            return self.host_spills[0]
        return merge_partials(self.host_spills, self.lanes)


def _compact(sc: count_sort.SortedCounts) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device SortedCounts -> host (unique words, counts, bins)."""
    idx = np.flatnonzero(np.asarray(sc.is_uniq))
    return (
        np.asarray(sc.words)[idx],
        np.asarray(sc.counts)[idx].astype(np.int64),
        np.asarray(sc.bins)[idx],
    )


def merge_partials(
    parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]], W: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host merge of per-batch unique tables.

    Semantically the cross-partition half of the reference's
    ``reduceByKey(_ ++ _)`` + heap merge; here the per-batch tables are
    already unique+sorted, so the native k-way heap merge applies
    (output.native fkmerge, O(N log P) one pass — the host-side
    priorityQueueWithIndexes analogue); the numpy lexsort + reduceat path
    below is the semantic reference and the fallback."""
    if len(parts) > 1:
        from .output import native as out_native

        merged = out_native.merge_sorted_parts(parts, W)
        if merged is not None:
            return merged
    words = np.concatenate([p[0] for p in parts], axis=0)
    counts = np.concatenate([p[1] for p in parts], axis=0)
    bins = np.concatenate([p[2] for p in parts], axis=0)
    if words.shape[0] == 0:
        return words, counts, bins
    order = np.lexsort(tuple(words[:, w] for w in reversed(range(W))))
    ws, cs, bs = words[order], counts[order], bins[order]
    new = np.empty(ws.shape[0], dtype=bool)
    new[0] = True
    np.any(ws[1:] != ws[:-1], axis=1, out=new[1:])
    starts = np.flatnonzero(new)
    return ws[starts], np.add.reduceat(cs, starts), bs[starts]


def count_batches(
    batches: Iterable[tuple[np.ndarray, int, int]],
    k: int,
    m: int,
    B: int,
    timer: StageTimer | None = None,
    engine: str = "sort",
    checkpointer=None,
    device_accumulate: bool | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
) -> CountResult:
    """Stream code batches through the device and return the merged table.

    ``prededup`` — per-batch count+compact before accumulation (pays on
    DUP-HEAVY inputs where the in-batch distinct ratio is low; the
    reference's (k,x) compression idea).  None (default) = adaptive, the
    mesh controller's design (parallel.stream): every 16th batch runs the
    dedup attempt itself as the probe — a fit admits the compact part and
    its prefetched distinct count steers the mode (engage under 0.24; the
    decision lands deterministically DEDUP_LAG batches later); an overflow at the npos/4 cap implies ratio > 0.25 and the
    batch's retained raw columns are admitted instead.
    True/False force the mode.
    """
    timer = timer or StageTimer()
    parts = []
    n_reads = 0
    n_bases = 0
    W = num_words(k)
    if unique_ub is not None and engine != "sort":
        # no silent flag drops: the HT engine's per-batch loop has no
        # host-side room checks to elide (the collision flag is already a
        # carried device scalar checked once) — nothing for the assertion
        # to buy, so asserting it is a caller error, not a no-op
        raise NotImplementedError(
            "unique_ub (sync-free accumulator feed) is a sort-engine "
            "feature; the HT engine has no per-batch sync to skip"
        )
    if prededup is True and engine != "sort":
        raise NotImplementedError(
            "prededup (per-batch count+compact) feeds the sort-engine "
            "accumulator; the HT engine already counts per batch"
        )
    if device_accumulate is None:
        # unique_ub and a forced prededup are accumulator contracts —
        # honoring them means taking the accumulator path on every
        # backend (CPU included), not just off-CPU
        device_accumulate = engine == "sort" and (
            unique_ub is not None or prededup is True
            or jax.default_backend() != "cpu"
        )
    device_accumulate = device_accumulate and engine == "sort"
    # k % 16 == 0: the bare sentinel is ambiguous; a constant-zero trailing
    # lane restores it (_batch_extract_keys_flagged), so the deferred
    # accumulator covers EVERY k
    flagged = device_accumulate and not count_sort.sentinel_safe_for(k)
    acc = (
        DeviceAccumulator(
            k, m=m, B=B, unique_ub=unique_ub, extra_lanes=1 if flagged else 0
        )
        if device_accumulate
        else None
    )
    # ENGAGE_BELOW sits just under the probe's 0.25 dcap ratio cap (beyond
    # which the probe overflows and dedup cannot engage at all): forced
    # dedup won at every engageable ratio on the previous accelerator.
    # Calibrated there; not yet measured on the H100.
    PROBE_EVERY, ENGAGE_BELOW = 16, 0.24
    # Short runs engage within a few batches WITHOUT a warm-up probe set:
    # the batch-0 probe's decision lands deterministically at batch
    # DEDUP_LAG.
    # DEDUP_LAG = batches between a dedup dispatch and its deterministic
    # admission:
    # deep enough that the prefetched scalars have landed (blocking read
    # is then free) and the dispatch pipeline stays full; still a FIXED
    # index lag, so admission order/timing is a pure function of the input
    # (calibrated on the previous accelerator; not yet measured on the H100)
    DEDUP_LAG = int(os.environ.get("FASTKMER_DEDUP_LAG", "3"))
    if flagged:
        # probe/dedup paths are W-lane shaped; k % 16 == 0 rides the
        # flagged extra lane.  Adaptive quietly stays raw; a FORCED
        # prededup must not be silently dropped (the mesh path supports
        # flagged x dedup — single-chip does not)
        if prededup is True:
            raise NotImplementedError(
                "single-chip prededup does not cover k % 16 == 0 (the "
                "flagged-lane extraction); use the mesh path or adaptive"
            )
        prededup = False
    dedup_mode = prededup is True
    # dedup parts are held OUT of the accumulator for DEDUP_LAG batches
    # and admitted at a DETERMINISTIC dispatch-index lag (the mesh
    # controller's lockstep-consumption idea, parallel.stream.PROBE_LAG):
    # by admission time the prefetched overflow/distinct scalars have
    # normally landed, so the blocking read is free, and mode flips /
    # window flushes happen at indices that are a pure function of the
    # INPUT, not of scalar-landing timing — merge windows then compose
    # identically across reruns, keeping the _MERGE_JIT variant set small
    # and warm (is_ready-timed admission compiled new merge variants on
    # every run).  An overflowed batch admits its retained raw-extraction
    # columns — never dropped, never fatal (adversarial-oscillation
    # safety).  Holding raw_cols for DEDUP_LAG batches pins
    # LAG * W * npos * 4 B of HBM (~0.5 GB at the production shape) —
    # the price of the free overflow fallback.
    dedup_pending: list = []  # (dispatch_idx, raw_cols, dcols, dwts, pos, n_u, over)
    # merge windows are kept SINGLE-KIND (all raw [npos] or all dedup
    # [dcap] parts): a part of the other kind closes the open window
    # first.  The kind sequence is a pure function of the input (lagged
    # admission), so window compositions — and thus the _MERGE_JIT
    # variant set — are identical across reruns and stay tiny.  Tracking
    # the kind at APPEND time (not at mode flips) matters: in-flight
    # lagged parts of the old kind land after a flip, and probe parts
    # land inside raw windows.
    window_kind: list = [None]

    def _feed_window(kind: str, add) -> None:
        if acc.pending and window_kind[0] != kind:
            acc._merge_pending()
        window_kind[0] = kind
        add()

    def _admit_dedup(entry) -> None:
        nonlocal dedup_mode
        _, raw_q, qcols, qwts, qpos, q_nu, q_over = entry
        if int(np.asarray(q_over)):
            # the input turned distinct-heavy: this batch's compaction
            # dropped uniques — admit the batch's ALREADY-EXTRACTED raw
            # columns (lossless, no second extraction pass); in adaptive
            # mode disengage
            _feed_window("raw", lambda: acc.add_raw(raw_q))
            if prededup is None:
                dedup_mode = False
            return
        _feed_window("dedup", lambda: acc.add_part(qcols, qwts))
        if prededup is None:
            ratio = int(np.asarray(q_nu)) / max(qpos, 1)
            dedup_mode = ratio < ENGAGE_BELOW

    skip = 0
    persisted_spills = 0
    if checkpointer is not None:
        # resume: previously persisted parts re-enter the final merge; the
        # covered batches are skipped below.  The accumulator path
        # checkpoints by forcing a spill every checkpointer.interval
        # batches (manifest.BatchCheckpointer spill flow), so resumable
        # runs keep the deferred device-resident fast path.
        skip = checkpointer.completed_batches()
        if acc is not None:
            acc.host_spills.extend(checkpointer.load_parts())
            persisted_spills = len(acc.host_spills)
        else:
            parts.extend(checkpointer.load_parts())
    coll_flag = jnp.zeros((), bool) if engine == "hash" else None
    for batch_idx, (codes, nr, nb) in enumerate(batches):
        if batch_idx < skip:  # already counted before the interruption
            n_reads += nr
            n_bases += nb
            continue
        # admit lagged dedup parts FIRST: mode decisions from batch
        # j - DEDUP_LAG take effect on this batch's dispatch kind
        if acc is not None and dedup_pending:
            with timer.span("device_merge"):
                while (
                    dedup_pending
                    and dedup_pending[0][0] <= batch_idx - DEDUP_LAG
                ):
                    _admit_dedup(dedup_pending.pop(0))
        # the dedup attempt IS the probe (the mesh controller's design,
        # parallel.stream): a probe batch runs _batch_count_dedup at
        # dcap = npos/4 — if it fits, the compact part is admitted AND its
        # distinct-count scalar steers the mode; if it overflows (ratio >
        # 0.25 > ENGAGE), _admit_dedup recounts it raw and disengages.
        # Compared to the old full-count probe this (a) costs dedup-price
        # on dup-heavy input instead of a 2x count, and (b) keeps every
        # part one of TWO shapes (raw [npos] / dedup [dcap]) in
        # single-kind merge windows (_feed_window)
        probe = (
            acc is not None
            and prededup is None
            and not dedup_mode
            and batch_idx % PROBE_EVERY == 0
        )
        with timer.span("device_count"):
            if engine == "hash":
                sc, coll_flag = _batch_count_ht(jnp.asarray(codes), coll_flag, k, m, B)
            elif acc is not None and (dedup_mode or probe):
                sc = None
                R_, L_ = codes.shape
                npos = R_ * (L_ - k + 1)
                dcap = (npos + (-npos % (1 << 16))) // 4
                codes_d = jnp.asarray(codes)
                dcols, dwts, d_nu, d_over, d_raw = _batch_count_dedup(
                    codes_d, k, m, B, dcap
                )
                for a in (d_nu, d_over):
                    a.copy_to_host_async()
            elif acc is not None:
                # deferred path: stage-1 extract only; the accumulator's
                # fan-in merge does all the sorting
                sc = None
                if flagged:
                    cols = _batch_extract_keys_flagged(jnp.asarray(codes), k, m, B)
                else:
                    cols = _batch_extract_keys(jnp.asarray(codes), k, m, B)
            else:
                sc = _batch_count(jnp.asarray(codes), k, m, B)
        if acc is not None:
            with timer.span("device_merge"):
                if dedup_mode or probe:
                    dedup_pending.append(
                        (batch_idx, d_raw, dcols, dwts, npos, d_nu, d_over)
                    )
                else:
                    _feed_window("raw", lambda: acc.add_raw(cols))
            if (
                checkpointer is not None
                and (batch_idx + 1) % checkpointer.interval == 0
            ):
                with timer.span("checkpoint"):
                    # in-flight dedup parts must be admitted BEFORE the
                    # spill is persisted: the checkpoint cursor claims every
                    # batch <= batch_idx is in the persisted spills, and an
                    # overflowed part's raw recount must not be lost to a
                    # crash (the device counters do not survive the process)
                    while dedup_pending:
                        _admit_dedup(dedup_pending.pop(0))
                    acc._merge_pending()
                    stats = acc._stats()
                    acc._raise_if_lost(stats)
                    acc._spill(stats)
                    acc.materialize_spills(block=True)  # persist = landed
                    checkpointer.save_spills(
                        batch_idx + 1,
                        acc.host_spills[persisted_spills:],
                        persisted_spills,
                    )
                    persisted_spills = len(acc.host_spills)
        else:
            with timer.span("host_compact"):
                part = _compact(sc)
                parts.append(part)
                if checkpointer is not None:
                    checkpointer.save_batch(batch_idx, *part)
        n_reads += nr
        n_bases += nb
    if coll_flag is not None and bool(np.asarray(coll_flag)):
        from .ops.count_hash import FingerprintCollision

        raise FingerprintCollision(
            "64-bit fingerprint collision; re-run with the sort engine"
        )
    while dedup_pending:  # drain in-flight dedup parts before finalize
        _admit_dedup(dedup_pending.pop(0))
    with timer.span("merge"):
        if acc is not None:
            words, counts, bins = acc.finalize()
            if flagged:
                words = words[:, :W]  # drop the constant validity lane
        elif parts:
            words, counts, bins = merge_partials(parts, W)
        else:
            words = np.zeros((0, W), np.uint32)
            counts = np.zeros(0, np.int64)
            bins = np.zeros(0, np.int32)
    return CountResult(
        words, counts, bins, int(counts.sum()), n_bases, n_reads, timer.as_dict()
    )


def execute_job(
    cfg: JobConfig,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    trace_dir: str | None = None,
    keep_table: bool = False,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    checkpoint_interval: int = 32,
) -> CountResult:
    """Count k-mers in cfg.dataset and (optionally) write per-bin files.

    Mirrors the reference orchestrator's switch matrix
    (SparkBinKmerCounter.scala:1023-1044); the sort and HT engines must
    produce identical tables, so engine choice only affects the device step.

    ``checkpoint_dir`` enables batch-level resume (output.manifest);
    ``trace_dir`` wraps the run in a jax.profiler trace.
    ``use_kryo_serializer`` maps to the binary output format (the Kryo
    writer was the reference's binary variant, SparkBinKmerCounter.scala:557).
    ``keep_table`` additionally writes a binary sidecar (table.npz) of the
    final table so ``repair_output`` can rewrite damaged bin files WITHOUT
    recounting the dataset (checksum-validated against the manifest).
    ``unique_ub`` — caller-asserted bound on distinct k-mers (e.g. genome
    length): enables the zero-sync accumulator feed; verified at finalize.
    """
    from .output import manifest as manifest_mod
    from .utils.timing import maybe_profile

    timer = StageTimer(verbose=False)
    if verbose:
        print(cfg.describe())
    ckpt = (
        manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
        if checkpoint_dir
        else None
    )
    from .ingest.prefetch import prefetched

    batches = prefetched(
        batching.batch_file(
            cfg.dataset, cfg.sequence_type, cfg.k, cfg.reads_per_batch, cfg.read_len
        )
    )
    engine = "hash" if cfg.use_ht else "sort"
    with maybe_profile(trace_dir):
        res = count_batches(
            batches, cfg.k, cfg.m, cfg.b, timer, engine=engine, checkpointer=ckpt,
            unique_ub=unique_ub, prededup=prededup,
        )
    if cfg.write:
        with timer.span("write_output"):
            if cfg.use_kryo_serializer:
                # npz + binary-flagged manifest with the npz hash, so
                # verify_output detects bit rot like the per-bin hashes
                writer.write_binary_with_manifest(
                    cfg.output_dir, dataclasses_dict(cfg), res.words,
                    res.counts, res.bins, cfg.k,
                )
            else:
                bin_hashes = writer.write_bin_files(
                    cfg.output_dir, res.words, res.counts, res.bins, cfg.k,
                    eof_sentinel=not cfg.use_ht,
                )
                manifest_mod.write_manifest(
                    cfg.output_dir, dataclasses_dict(cfg), res.words,
                    res.counts, res.bins, bin_hashes=bin_hashes,
                )
            if keep_table:
                manifest_mod.write_table_sidecar(
                    cfg.output_dir, res.words, res.counts, res.bins
                )
    if ckpt is not None:
        ckpt.clear()  # run completed; checkpoints no longer needed
    return res._replace(timings=timer.as_dict())


def dataclasses_dict(cfg: JobConfig) -> dict:
    import dataclasses

    return {k: v for k, v in dataclasses.asdict(cfg).items() if not callable(v)}


def repair_output(cfg: JobConfig, verbose: bool = True) -> dict:
    """Idempotent re-run of failed bins (SURVEY §5: the recovery mechanism
    the reference's commented-out bin bookkeeping gestured at,
    SparkBinKmerCounter.scala:608-639): verify the manifest and rewrite
    ONLY the missing/mismatched bin files.

    Source of truth, in order of cost: a checksum-valid ``table.npz``
    sidecar (written by ``execute_job(keep_table=True)``) rewrites bad bins
    with ZERO recounting; otherwise the dataset is fully recounted —
    counting is pure, so this is exact but touches every batch.
    """
    import json

    from .output import manifest as manifest_mod

    status = manifest_mod.verify_output(cfg.output_dir)
    if status["ok"]:
        return status
    with open(os.path.join(cfg.output_dir, manifest_mod.MANIFEST)) as f:
        man = json.load(f)
    if man.get("binary"):
        extras = man.get("extra_files", {})
        if "shards" in man or any(n.startswith("counts.part") for n in extras):
            # multi-host sharded binary output: each process owns its
            # counts.part<N>.npz and no single process holds the full
            # table — re-run the shard's owner instead of a lossy
            # single-process "repair" that would orphan the shards
            raise NotImplementedError(
                "sharded binary outputs (counts.part<N>.npz) are repaired "
                "by re-running their owning processes; single-process "
                "repair_output covers counts.npz only"
            )
        bad_extras = set(status["extra_missing"]) | set(status["extra_mismatched"])
        if "counts.npz" not in bad_extras:
            # the only rebuildable artifact here is the count table; a
            # damaged sibling (e.g. multiseq distances.json) needs its
            # own job re-run — report rather than recount for nothing
            return status
        # regenerate counts.npz whole (sidecar first, recount otherwise)
        # through the shared binary writer, preserving sibling hashes
        if verbose:
            print("repairing binary output (counts.npz)")
        table = manifest_mod.load_table_sidecar(cfg.output_dir)
        if table is None:
            res = execute_job(dataclasses_replace(cfg, write=False), verbose=False)
            table = (res.words, res.counts, res.bins)
        words, counts, bins = table
        siblings = {n: h for n, h in extras.items() if n != "counts.npz"}
        writer.write_binary_with_manifest(
            cfg.output_dir, man["config"], words, counts, bins, cfg.k,
            extra_files=siblings,
        )
        return manifest_mod.verify_output(cfg.output_dir)
    bad = set(status["missing"]) | set(status["mismatched"])
    if verbose:
        print(f"repairing {len(bad)} bins: {sorted(bad)}")
    table = manifest_mod.load_table_sidecar(cfg.output_dir)
    if table is not None:
        words, counts, bins = table
        if verbose:
            print("repairing from table.npz sidecar (no recount)")
    else:
        # recount (pure) and rewrite only the bad bins
        res = execute_job(dataclasses_replace(cfg, write=False), verbose=False)
        words, counts, bins = res.words, res.counts, res.bins
    sel = np.isin(bins, list(bad))
    writer.write_bin_files(
        cfg.output_dir, words[sel], counts[sel], bins[sel], cfg.k,
        eof_sentinel=not cfg.use_ht, clean=False,  # partial rewrite
    )
    return manifest_mod.verify_output(cfg.output_dir)


def dataclasses_replace(cfg: JobConfig, **kw) -> JobConfig:
    import dataclasses

    return dataclasses.replace(cfg, **kw)
