"""Streaming distributed counter with per-chip device-resident tables.

parallel.driver's simple path pulls every batch's per-chip table to the
host; over the host link at scale that is the wrong shape.  This module
keeps all cross-batch state INSIDE the device:

  per batch   exchange_step(codes, owner_tab) ->
                extract -> route -> all_to_all          (as exchange.py)
              (NO sort-count per batch; the received rows are buffered
              on device — "pending" parts)

  every ``fanin`` batches (or when the accumulator budget forces it)
              merge_step(parts..., acc) ->
                ONE weighted sentinel-sort over (pending rows, accumulated
                uniques) + scan-only run totals + block-compaction
                (count_sort.compact_marked) back to the [acc_cap]
                accumulator

This is the device analogue of the reference's reduce-side state (Spark
shuffle files + ``reduceByKey`` aggregation buffers,
SparkBinKmerCounter.scala:1035): sorted-run merging instead of a JVM heap.
Batching ``fanin`` exchanges per merge amortizes the big sort exactly like
the reference amortizes its per-bin quicksort over a whole partition.

Duplication-aware transport (``prededup``): the reference's shuffle payload
is the super-k-mer — maximal same-signature runs shipped as one packed
record (getSuperKmers, SparkBinKmerCounter.scala:34-169, shuffled at
:1031-1036) — because shuffling ``run + k - 1`` bases beats shuffling
``run`` full k-mers.  Shipping smer records here was measured and rejected
(expansion padding multiplies merge-sort rows ~18x); the same
interconnect economics WITHOUT the padding is per-chip pre-exchange
weighted dedup: count+route (k-mer words, weight) instead of raw
per-position rows, cutting exchange lanes AND merge rows by the in-batch
duplication factor.  Like the single-chip pipeline, the mode is adaptive
(probe batches measure the in-batch distinct ratio; dedup engages when it
drops below the threshold) — raw transport wins on low-duplication input
because dedup pays one extra local sort per batch.

The host only ever moves scalars (overflow counters, at merge boundaries at
most) and pulls each chip's final stacked (words, count, bin) table once at
the end — or, when the distinct-k-mer count outgrows ``acc_cap``, spills
the accumulator to the host at a merge boundary and keeps going, so any
genome fits regardless of the device budget.

Fixed capacities (jit programs have static shapes): ``cap`` bounds
per-(src,dst) exchange lanes (``cap_d`` its dedup-mode sibling, sized from the measured
distinct ratio), ``acc_cap`` bounds distinct k-mers held per chip; all
overflow is DETECTED via psum'd counters, never silent.

Compaction back to acc_cap is block-local sorts + scan placement
(count_sort.compact_marked) — no scatter and no gather.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.bits import num_words
from ..ops import binhash, count_sort, extract
from . import exchange

AXIS = exchange.AXIS
_ONES = jnp.uint32(0xFFFFFFFF)
_WT_LIMIT = count_sort.WEIGHT_LIMIT  # int32 run-total wrap guard
_INIT_CACHE: dict = {}  # (mesh, n, acc_cap, W) -> jitted on-device init


class AccState(NamedTuple):
    words: jnp.ndarray  # [n, acc_cap, W] sentinel-padded unique k-mers, sorted
    wts: jnp.ndarray  # [n, acc_cap] int32 counts
    n_unique: jnp.ndarray  # [n] int32, REPLICATED (all_gathered at merge)
    dropped: jnp.ndarray  # [] int32 cumulative exchange overflow
    overflow: jnp.ndarray  # [] int32 cumulative accumulator overflow


class _Part(NamedTuple):
    """One buffered exchange result awaiting the fan-in merge.

    cols:  tuple of W [n, rows] uint32 key lanes (sentinel on dead slots)
    wts:   [n, rows] int32 weights for dedup parts, None for raw parts
           (raw rows weigh 1 where non-sentinel)
    ndrop: [] replicated psum'd dropped-entry count of this exchange
    """

    cols: tuple
    wts: jnp.ndarray | None
    ndrop: jnp.ndarray


def _quantize_cap(v: int) -> int:
    """Round a capacity UP to the {pow2, 1.5*pow2} grid (bounded compile
    set, <=50% padding), floor 512."""
    v = max(512, v)
    p2 = 1 << (v - 1).bit_length()
    return p2 * 3 // 4 if p2 * 3 // 4 >= v else p2


def _merge_cap_in(n_rows: int) -> int:
    """Merge-sort input width for ``n_rows``: 64Ki granules (bounded
    compile set), EXCEPT padded up to a power of two when within 10% —
    lax.sort at pow2 row counts was cheaper per element on the previous
    accelerator (calibrated there; not yet measured on the H100)."""
    cap_in = -(-n_rows // (1 << 16)) * (1 << 16)
    p2 = 1 << (n_rows - 1).bit_length()
    if p2 <= n_rows * 1.10:
        cap_in = max(cap_in, p2)
    return cap_in


class _PendingSpill:
    """A spilled per-chip table slice whose D2H copy is in flight; ``chip``
    lets the in-flight bound apply PER CHIP (under bin skew all pending
    slices can come from one chip, and the bound exists to cap that chip's
    pinned HBM — ADVICE r3).  Deliberately NOT a NamedTuple: materialized
    spills are plain tuples, and callers distinguish the two states with
    ``isinstance(s, tuple)``."""

    __slots__ = ("data", "chip")

    def __init__(self, data, chip: int):
        self.data = data
        self.chip = chip


class DistributedCounter:
    """Multi-batch streaming counter over a 1-D mesh (k % 16 != 0).

    ``cap``      per-(src,dst) all_to_all lane capacity (k-mers).
    ``acc_cap``  distinct k-mers held on each chip between host spills.
    ``fanin``    exchanges buffered per merge sort.
    ``with_seq`` multisequence mode: a per-read sequence id rides the
                 exchange as one extra uint32 key lane, so the tables
                 count (k-mer, seq) pairs — the KmerWithSequence analogue
                 (reference: package.scala:506-509, multiseq shuffle at
                 SparkMultiSequenceKmerCounter.scala:587-588).
    ``unique_ub`` caller-asserted bound on TOTAL distinct k-mers (e.g.
                 genome length).  Makes the feed loop SYNC-FREE, exactly
                 like the single-chip DeviceAccumulator: acc_cap is bumped
                 to cover the bound, all host-side room checks and the
                 per-merge dropped-counter pull are skipped, and the
                 device counters (overflow AND exchange drops) are
                 verified once at finalize — asserted, never trusted.
                 The Spark analogue is the fire-and-forget shuffle write:
                 no ack per record, failure surfaces at stage end.
    ``prededup`` pre-exchange weighted dedup (see module docstring).
                 None (default) = adaptive: every PROBE_EVERY-th batch
                 (batch 0 included — short runs engage at batch
                 PROBE_LAG, VERDICT r4 #2) runs the dedup exchange
                 regardless of mode; its psum'd
                 distinct count is prefetched and the mode follows the
                 measured in-batch ratio.  True/False force the mode.
                 Probe scalars are consumed at DETERMINISTIC batch
                 indices (dispatch + PROBE_LAG, a lagged normally-landed
                 materialize) on EVERY process count: reruns compile the
                 same program variants, and on a multi-host mesh every
                 process switches modes at the same batch so the
                 collective program sequence stays in lockstep.
    """

    PROBE_EVERY = 16
    # Short runs engage within a few batches because probe 0's decision
    # lands deterministically at batch PROBE_LAG (round 4's ~30% short-run
    # forfeit was is_ready-timed engagement).  A richer warm-up set
    # ({0,1,2,4,8}) was tried and CUT BACK to {0}: until the first retune
    # lands, a probe ships at cap_d == cap with the weight lane — (W+1)/W
    # the bytes of a raw batch and the same row count, so extra pre-retune
    # probes cost transport in EVERY regime while the deterministic lag
    # means they cannot engage any earlier (the byte regression was caught
    # by tests/test_stream_dedup.py's engage test).  The set is STATIC —
    # mode flips must happen at identical batch indices on every process.
    WARMUP_PROBES = frozenset((0,))
    # engage threshold: forced dedup vs raw broke even near a per-chip
    # distinct ratio of ~0.35 on the previous accelerator, so 0.30 engages
    # with margin below it (calibrated there; not yet measured on the
    # H100).  The single-chip pre-dedup has its own 0.24 — its
    # dedup-as-probe cap bounds engagement at 0.25 and its economics lack
    # the exchange-byte win; pipeline.count_batches.
    ENGAGE_BELOW = 0.30
    # batches between a probe's dispatch and its (blocking, normally
    # landed) consumption — deterministic on every process count, see
    # _consume_probes.  3 balances engage latency against pipeline depth
    # (the single-chip DEDUP_LAG sweep measured 3/6/10 flat); was 16 when
    # only multi-host used the deterministic path
    PROBE_LAG = 3

    def __init__(self, mesh: Mesh, k: int, m: int, B: int, cap: int, acc_cap: int,
                 owner_map: np.ndarray, fanin: int = 4, with_seq: bool = False,
                 retry_on_overflow: bool = True, unique_ub: int | None = None,
                 prededup: bool | None = None):
        assert count_sort.sentinel_safe_for(k) or with_seq, (
            "streaming counter needs k % 16 != 0 (or a seq lane, which is "
            "itself sentinel-safe)"
        )
        self.mesh = mesh
        self.k, self.m, self.B = k, m, B
        self.with_seq = with_seq
        self.Wk = num_words(k)  # k-mer words only
        self.W = self.Wk + (1 if with_seq else 0)  # key lanes incl. seq
        self.n = mesh.shape[AXIS]
        self.cap = cap
        self.assume_fits = unique_ub is not None
        if unique_ub is not None:
            # next 64Ki granule + 2 granules of slack (the single-chip
            # rule, pipeline.DeviceAccumulator): bins partition k-mers
            # across chips so any one chip holds <= the global bound.  The
            # slack is granules, not a % headroom — a % headroom pushes
            # the merge window past the pow2 (_merge_cap_in)
            acc_cap = max(
                acc_cap, (-(-int(unique_ub) // (1 << 16)) + 2) * (1 << 16)
            )
        self.acc_cap = acc_cap
        self.fanin = fanin
        self.owner = np.asarray(owner_map, dtype=np.int32)
        self._exchange = self._build_exchange()
        self._exchange_dedup = None  # built on first dedup/probe dispatch
        self._merge_cache: dict[tuple, callable] = {}
        self._stack = None  # built lazily (first table pull)
        self.state = self._init_state()
        self.pending: list[_Part] = []
        self.host_spills: list = []  # _PendingSpill | (words, counts, bins)
        self._acc_ub = 0  # conservative upper bound on per-chip uniques
        self._pend_ub = 0  # conservative upper bound on pending new uniques
        self._wt_dev = 0  # bound on total instance weight on device
        self.rows = 0  # per-chip rows buffered in pending parts
        self.n_bases = 0
        self.n_reads = 0
        self.retry_on_overflow = retry_on_overflow
        self._window: list = []  # current merge window's inputs, for replay
        self._cap_limit = cap  # grows with observed per-src positions
        self.exchange_bytes = 0  # cumulative bytes crossing the interconnect
        self.n_retries = 0
        self.merge_shapes: list = []  # (n_rows, padded cap_in) per merge
        # --- adaptive pre-exchange dedup state ---
        self.prededup = prededup
        # dedup-mode per-(src,dst) capacity.  Starts at the raw cap (no
        # information), EXCEPT when unique_ub is asserted: a chip's local
        # batch distinct count is bounded by the GLOBAL distinct bound, so
        # cap_d = unique_ub (rounded up) can never drop a routed row even
        # if every unique lands on one destination — this removes the
        # cold-start where a sync-free feed finishes before the first
        # ratio scalar lands and dedup ships at full raw capacity.
        self.cap_d = cap
        if unique_ub is not None:
            self.cap_d = min(cap, _quantize_cap(int(unique_ub)))
        # once a drop forces a doubling, retunes may never shrink below the
        # doubled value: the ratio is a GLOBAL average, so a skewed
        # destination can overflow a ratio-sized cap_d repeatedly — without
        # the floor, retry-double -> probe-shrink would oscillate and every
        # window would re-exchange twice (code-review r4 finding).  Starts
        # at 0 — a nonzero initial floor could push cap_d past tiny
        # caps/_cap_limit (found by the retry tests at cap=8)
        self._cap_d_floor = 0
        self._dedup_mode = prededup is True
        self._batch_i = 0
        self.n_dedup_batches = 0
        self._probe_pending: list = []  # (consume_at, positions, n_u scalar)
        self._multihost = jax.process_count() > 1

    def _init_state(self) -> AccState:
        # built ON DEVICE: device_put of host sentinel padding ships
        # n*acc_cap*(W+1)*4 bytes over the host link for nothing
        key = (self.mesh, self.n, self.acc_cap, self.W)
        fn = _INIT_CACHE.get(key)
        if fn is None:
            n, acc_cap, W = self.n, self.acc_cap, self.W
            dev = NamedSharding(self.mesh, P(AXIS))
            rep = NamedSharding(self.mesh, P())
            fn = jax.jit(
                lambda: AccState(
                    words=jnp.full((n, acc_cap, W), 0xFFFFFFFF, jnp.uint32),
                    wts=jnp.zeros((n, acc_cap), jnp.int32),
                    n_unique=jnp.zeros(n, jnp.int32),  # replicated (see merge)
                    dropped=jnp.int32(0),
                    overflow=jnp.int32(0),
                ),
                out_shardings=AccState(dev, dev, rep, rep, rep),
            )
            _INIT_CACHE[key] = fn
        return fn()

    # ------------------------------------------------------------------ #
    # per-batch exchange: extract -> route -> all_to_all (NO sort/count) #
    # ------------------------------------------------------------------ #
    def _build_exchange(self):
        """Raw transport: one [n*cap] lane per key word per (src,dst).
        Dead slots (invalid positions, unfilled capacity) ship AS the
        sentinel — no ok lane crosses the interconnect (route_by_owner
        fills), so the per-row cost is W uint32, matching the payload the
        Spark shuffle would serialize (words only)."""
        k, n, cap = self.k, self.n, self.cap
        Wk, W, with_seq = self.Wk, self.W, self.with_seq
        in_specs = (P(AXIS, None), P(AXIS), P()) if with_seq else (P(AXIS, None), P())

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=(tuple(P(AXIS) for _ in range(W)), P()),
        )
        def ex_step(codes, *rest):
            owner_tab = rest[-1]
            ex = extract.extract(codes, self.k, self.m, self.B)
            owner = owner_tab[ex.bins]
            cols = [ex.words[:, w] for w in range(Wk)]
            if with_seq:
                R, L = codes.shape
                Pp = L - k + 1
                seq_col = jnp.broadcast_to(
                    rest[0][:, None].astype(jnp.uint32), (R, Pp)
                ).reshape(R * Pp)
                cols.append(seq_col)
            routed, _bok, ndrop = exchange.route_by_owner(
                owner, ex.valid, tuple(cols), n, cap, fills=(_ONES,) * W
            )
            recv = [exchange._all_to_all(c) for c in routed]
            return tuple(c[None] for c in recv), jax.lax.psum(ndrop, AXIS)

        jitted = jax.jit(ex_step)
        owner_arr = self.owner
        if with_seq:
            return lambda codes, seq_ids: jitted(codes, seq_ids, owner_arr)
        return lambda codes, seq_ids=None: jitted(codes, owner_arr)

    def _build_exchange_dedup(self):
        """Dedup transport: per chip, count this batch's positions locally
        (ONE extra W-key sort), then route (k-mer words, int32 weight) for
        the unique rows only — the weight lane takes the slot the ok lane
        used to burn, and ``cap_d`` tracks the distinct share instead of
        the position share.  Also returns the psum'd distinct count, the
        adaptive controller's signal.  This is the mesh form of the
        reference's super-k-mer shuffle compression
        (SparkBinKmerCounter.scala:34-169, :1031-1036): same
        interconnect-bytes economics, none of the expansion padding."""
        k, m, B, n = self.k, self.m, self.B, self.n
        cap_d = self.cap_d
        Wk, W, with_seq = self.Wk, self.W, self.with_seq
        in_specs = (P(AXIS, None), P(AXIS), P()) if with_seq else (P(AXIS, None), P())

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=(tuple(P(AXIS) for _ in range(W)), P(AXIS), P(), P()),
        )
        def ex_step(codes, *rest):
            owner_tab = rest[-1]
            ex = extract.extract(codes, self.k, self.m, self.B)
            cols = [jnp.where(ex.valid, ex.words[:, w], _ONES) for w in range(Wk)]
            if with_seq:
                R, L = codes.shape
                Pp = L - k + 1
                seq_col = jnp.broadcast_to(
                    rest[0][:, None].astype(jnp.uint32), (R, Pp)
                ).reshape(R * Pp)
                cols.append(jnp.where(ex.valid, seq_col, _ONES))
            sc = count_sort.count_presentineled(cols)
            # bins are recomputed from the sorted unique words (binhash
            # convention: never carried through sorts); sentinel rows get
            # an arbitrary owner but is_uniq excludes them from routing
            bins = binhash.bins_from_words(sc.words[:, :Wk], k, m, B)
            owner = owner_tab[bins]
            rcols = tuple(sc.words[:, w] for w in range(W)) + (sc.counts,)
            fills = (_ONES,) * W + (jnp.int32(0),)
            routed, _bok, ndrop = exchange.route_by_owner(
                owner, sc.is_uniq, rcols, n, cap_d, fills=fills
            )
            recv = [exchange._all_to_all(c) for c in routed]
            # sum of PER-CHIP local distinct counts (cross-chip duplicates
            # are not collapsed until the merge): n_u / positions is
            # exactly the row-compression factor this transport achieves,
            # which is what the adaptive threshold should measure
            n_u = jax.lax.psum(jnp.sum(sc.is_uniq.astype(jnp.int32)), AXIS)
            return (
                tuple(c[None] for c in recv[:W]),
                recv[W][None],
                jax.lax.psum(ndrop, AXIS),
                n_u,
            )

        jitted = jax.jit(ex_step)
        owner_arr = self.owner
        if with_seq:
            return lambda codes, seq_ids: jitted(codes, seq_ids, owner_arr)
        return lambda codes, seq_ids=None: jitted(codes, owner_arr)

    # ------------------------------------------------------------------ #
    # merge: pending parts + accumulator -> accumulator                  #
    # ------------------------------------------------------------------ #
    def _build_merge(self, part_descs: tuple):
        """``part_descs``: per pending part, (rows per chip, has_weights).
        Raw parts weigh 1 per non-sentinel row; dedup parts carry their
        routed int32 weight lane."""
        n, acc_cap, W = self.n, self.acc_cap, self.W
        n_rows = sum(r for r, _ in part_descs) + acc_cap
        cap_in = _merge_cap_in(n_rows)
        specs_part = tuple(
            tuple(P(AXIS) for _ in range(W + (1 if hw else 0)))
            for _, hw in part_descs
        )
        acc_spec = AccState(P(AXIS), P(AXIS), P(), P(), P())

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(specs_part, tuple(P() for _ in part_descs), acc_spec),
            out_specs=acc_spec,
        )
        def merge(parts, ndrops, acc: AccState) -> AccState:
            pad = cap_in - n_rows
            mcols = []
            for w in range(W):
                segs = [p[w][0] for p in parts] + [acc.words[0][:, w]]
                if pad:
                    segs.append(jnp.full(pad, _ONES, jnp.uint32))
                mcols.append(jnp.concatenate(segs))
            # raw rows weigh 1 where non-sentinel; dedup rows carry their
            # routed weights (0 on dead slots); accumulated uniques their
            # counts
            wsegs = []
            for p, (_, hw) in zip(parts, part_descs):
                if hw:
                    wsegs.append(p[W][0])
                else:
                    wsegs.append((p[W - 1][0] != _ONES).astype(jnp.int32))
            wsegs.append(acc.wts[0])
            if pad:
                wsegs.append(jnp.zeros(pad, jnp.int32))
            wts = jnp.concatenate(wsegs)
            # all inputs are pre-sentineled with zero weights on sentinel
            # rows — skip count_sorted's validity rewrite pass entirely
            sc = count_sort.count_presentineled(mcols, weights=wts)
            # compaction to acc_cap: block-local sorts + scan placement
            # (count_sort.compact_marked) — never a global sort (7x dearer
            # at merge width), never a gather/scatter; sentinel-safety is
            # asserted in the ctor
            ncols, new_wts, n_u, over = count_sort.compact_marked(
                tuple(sc.words[:, w] for w in range(W)), sc.counts, sc.is_uniq,
                acc_cap, block=1 << 15,
            )
            new_words = jnp.stack(ncols, axis=1)
            return AccState(
                words=new_words[None],
                wts=new_wts[None],
                # replicated: every process can fetch it and reach the
                # same spill decision (an axis-sharded vector would span
                # non-addressable devices on a multi-host mesh).  One-hot
                # psum, not all_gather: psum output is statically known
                # to be replicated (out_specs P() demands that proof)
                n_unique=jax.lax.psum(
                    jnp.where(
                        jnp.arange(n, dtype=jnp.int32)
                        == jax.lax.axis_index(AXIS),
                        jnp.minimum(n_u, acc_cap),
                        0,
                    ),
                    AXIS,
                ),
                # ndrops are replicated psums already — no psum here
                dropped=acc.dropped + sum(ndrops),
                overflow=acc.overflow + jax.lax.psum(over, AXIS),
            )

        # donate only the accumulator: part buffers never alias any output
        # shape, so donating them just emits 'unusable donation' warnings
        return jax.jit(merge, donate_argnums=(2,))

    def _merge_pending(self) -> None:
        if not self.pending:
            return
        # assume_fits: the dropped-counter pull is itself a host sync —
        # skip it; the accumulated state.dropped raises at finalize
        if self.retry_on_overflow and not self.assume_fits:
            self._retry_window_if_dropped()
        descs = tuple(
            (int(p.cols[0].shape[-1]), p.wts is not None) for p in self.pending
        )
        if descs not in self._merge_cache:
            self._merge_cache[descs] = self._build_merge(descs)
        n_rows = sum(r for r, _ in descs) + self.acc_cap
        self.merge_shapes.append((n_rows, _merge_cap_in(n_rows)))  # pow2 audit
        parts = tuple(
            p.cols + ((p.wts,) if p.wts is not None else ())
            for p in self.pending
        )
        ndrops = tuple(p.ndrop for p in self.pending)
        self.state = self._merge_cache[descs](parts, ndrops, self.state)
        self.pending = []
        self._window = []
        self.rows = 0
        self._acc_ub = min(self._acc_ub + self._pend_ub, self.acc_cap)
        self._pend_ub = 0
        # start the counters' D2H copies NOW (hides the round trip if the
        # host later needs them for a spill decision)
        for a in (self.state.n_unique, self.state.dropped, self.state.overflow):
            a.copy_to_host_async()

    def _ensure_room(self, incoming: int) -> None:
        """Keep the next merge's unique-count bound within acc_cap, spilling
        the accumulator to the host when it genuinely cannot absorb the
        incoming batch.  Conservative bounds avoid device pulls entirely in
        the common case; at most a few scalar pulls happen per spill."""
        if self._acc_ub + self._pend_ub + incoming <= self.acc_cap:
            return
        stats = self._stats()  # exact occupancy before deciding to spill
        self._acc_ub = max(stats["n_unique"], default=0)
        while self._acc_ub + self._pend_ub + incoming > self.acc_cap:
            if self.pending:
                # merge first: duplicates may collapse the conservative
                # pending bound far below acc_cap (no spill needed at all)
                self._merge_pending()
                stats = self._stats()
                self._acc_ub = max(stats["n_unique"], default=0)
            elif self._acc_ub > 0:
                self._raise_if_lost(stats)
                self.host_spills.extend(self._pull_tables(stats))
                self.state = self._init_state()
                self._acc_ub = 0
                self._wt_dev = 0  # pending is empty on this branch
                self.materialize_spills(block=False)  # free landed spills
                self._bound_inflight()
            else:
                # a single batch exceeds acc_cap: the device overflow
                # counter records the loss and finalize raises
                break

    # ------------------------------------------------------------------ #
    # adaptive dedup controller                                          #
    # ------------------------------------------------------------------ #
    def _consume_probes(self) -> None:
        """Apply probe/dedup distinct-ratio measurements to the transport
        mode and ``cap_d`` at DETERMINISTIC batch indices (dispatch index
        + PROBE_LAG) with a blocking materialize — single-process AND
        multi-host.  The value is prefetched and by then PROBE_LAG
        batches old (normally long landed), so the block is free; mode
        flips and cap_d retunes — each a NEW exchange/merge program —
        land at indices that are a pure function of the input, so the
        jit-variant set is identical across reruns (is_ready-timed
        decisions made every run compile fresh merge compositions).
        Multi-host additionally relies on the same property for lockstep:
        every process switches modes at the same batch, keeping the
        collective program sequence aligned.

        Forced mode (prededup=True) consumes the same scalars but only for
        ``cap_d`` retuning — the transport stays dedup regardless."""
        while self._probe_pending:
            consume_at, pos, arr = self._probe_pending[0]
            if self._batch_i < consume_at:
                break
            self._probe_pending.pop(0)
            ratio = int(np.asarray(arr)) / max(pos, 1)
            if self.prededup is None:
                self._dedup_mode = ratio < self.ENGAGE_BELOW
            if self._dedup_mode or self.prededup is True:
                self._retune_cap_d(ratio)

    def _retune_cap_d(self, ratio: float) -> None:
        """Size the dedup-mode exchange capacity from the measured distinct
        ratio: distinct rows per (src,dst) shrink with the position share,
        so cap_d ~ cap * ratio * slack, quantized to a {pow2, 1.5*pow2}
        grid (bounded compile set, <=50% padding), floored, never above
        the raw cap.  Growth beyond the target (a mid-run duplication
        shift) is covered by the drop-detect + retry-at-doubled-cap
        machinery, same as the raw path.

        Sync-free mode (assume_fits) never retunes: there is no retry net
        there, and the ctor already fixed cap_d at the provably-safe
        unique_ub size (a chip's local distinct count cannot exceed the
        asserted global bound)."""
        if self.assume_fits:
            return
        target = min(_quantize_cap(int(self.cap * min(1.0, ratio) * 1.5)),
                     self.cap)
        target = max(target, self._cap_d_floor)
        if target != self.cap_d:
            self.cap_d = target
            self._exchange_dedup = None  # rebuild at the new capacity

    def feed(self, codes: np.ndarray, n_reads: int = 0, n_bases: int = 0,
             seq_ids: np.ndarray | None = None) -> None:
        """Dispatch one batch's exchange.  ``codes``/``seq_ids`` may be
        aliased zero-copy by jax (CPU backend) and the dispatch is async:
        the caller MUST NOT mutate them afterwards — pass fresh arrays."""
        R, L = codes.shape
        # multi-host: codes is this process's stripe; bounds are global
        R = R * jax.process_count()
        positions = R * max(L - self.k + 1, 0)
        if self._wt_dev + positions > _WT_LIMIT:
            # int32 run-total wrap guard — applies even under assume_fits
            # (it bounds weights, not capacity); forces one host spill per
            # ~2^31 instances, so the guard never shows up in steady state
            self.spill()
        self._consume_probes()
        if self.prededup is True:
            use_dedup = True
        elif self.prededup is False:
            use_dedup = False
        else:
            use_dedup = (
                self._dedup_mode
                or self._batch_i % self.PROBE_EVERY == 0
                or self._batch_i in self.WARMUP_PROBES
            )
        mode_cap = self.cap_d if use_dedup else self.cap
        # per-chip new-unique bound: a chip cannot receive more rows than
        # its n*cap exchange lanes hold, nor more than the batch contains
        uniq_charge = min(positions, self.n * mode_cap)
        if not self.assume_fits:
            self._ensure_room(uniq_charge)
        if len(self.pending) >= max(2, self.fanin - 2):
            # pow2 merge scheduling (the single-chip
            # DeviceAccumulator._append trigger): when the buffered rows +
            # accumulator sit just under a power of two and this part
            # would cross it, merge NOW (see _merge_cap_in; _build_merge
            # pads the <=10% remainder).  Gated on a near-full window so
            # the pow2 bonus never trades away fan-in amortization
            cur = self.rows + self.acc_cap
            p2 = 1 << (cur - 1).bit_length()
            if p2 <= cur * 1.10 and cur + self.n * mode_cap > p2:
                self._merge_pending()
        sharded = exchange.shard_batch(self.mesh, codes)
        sids = None
        if self.with_seq:
            sids = exchange.shard_vector(
                self.mesh, np.asarray(seq_ids, dtype=np.int32)
            )
        self._dispatch(sharded, sids, use_dedup, positions)
        # retry needs the (immutable) device inputs and per-src extraction
        # bound; per-src rows also bound how far cap can usefully grow
        src_positions = (-(-R // self.n)) * max(L - self.k + 1, 0)
        if not self.assume_fits:  # sync-free mode never replays a window
            self._window.append((sharded, sids, positions, use_dedup))
        self._cap_limit = max(self._cap_limit, src_positions)
        self._pend_ub += uniq_charge
        # dedup rows carry weights > 1, so the weight charge is the full
        # batch position count in both modes (conservative for raw, where
        # it was previously clipped at the lane capacity)
        self._wt_dev += positions
        self.n_reads += n_reads
        self.n_bases += n_bases
        self._batch_i += 1
        if len(self.pending) >= self.fanin:
            self._merge_pending()

    def _dispatch(self, sharded, sids, use_dedup: bool, positions: int) -> None:
        if use_dedup:
            if self._exchange_dedup is None:
                self._exchange_dedup = self._build_exchange_dedup()
            cols, wts, ndrop, n_u = self._exchange_dedup(sharded, sids)
            self.pending.append(_Part(cols, wts, ndrop))
            self.rows += self.n * self.cap_d
            self.n_dedup_batches += 1
            # W key lanes + the int32 weight lane — the ok lane folded
            # into the sentinel, so dedup adds one lane but multiplies by
            # the (much smaller) distinct capacity
            self.exchange_bytes += self.n * self.cap_d * (self.W + 1) * 4
            # the distinct-count scalar steers mode (adaptive) AND cap_d
            # retuning (all modes) — prefetched, consumed lazily
            if self.prededup is not False:
                n_u.copy_to_host_async()
                self._probe_pending.append(
                    (self._batch_i + self.PROBE_LAG, positions, n_u)
                )
        else:
            cols, ndrop = self._exchange(sharded, sids)
            self.pending.append(_Part(cols, None, ndrop))
            self.rows += self.n * self.cap
            # key lanes only: dead slots ship as the sentinel, no ok lane
            # (exchange.route_by_owner fills) — the one definition shared
            # with exchange.exchange_bytes_per_step
            self.exchange_bytes += self.n * self.cap * self.W * 4

    def _retry_window_if_dropped(self) -> None:
        """Exchange-overflow recovery (the moral equivalent of Spark
        spilling): pull the window's psum'd dropped counters (one small
        transfer — the merge would wait on the newest exchange anyway) and,
        if any entry was dropped, rebuild the overflowed exchange(s) at
        doubled capacity and replay the retained window inputs (each with
        its original transport mode).  Capacity is clipped at the per-src
        worst case, where overflow is impossible by construction (distinct
        rows <= positions, so the same clip bounds cap_d).

        The replay re-runs the feed-time CAPACITY checks per batch: the
        doubled cap raises each replayed batch's per-chip unique bound, so
        a window that fit acc_cap when fed can exceed it when retried — the
        replay must be allowed to merge sub-windows and spill between them,
        exactly like feed() (found by the retry+spill fuzz,
        tests/test_adaptive_fuzz.py).  _ensure_room may recurse into
        _merge_pending for the ALREADY-replayed prefix; self._window holds
        exactly that prefix at all times, so a nested retry replays a
        consistent set."""
        while True:
            drops = np.asarray(jnp.stack([p.ndrop for p in self.pending]))
            if int(drops.sum()) == 0:
                return
            # each part's dispatch-time capacity is recoverable from its
            # own shape (lanes = n * cap_at_dispatch) — retunes can change
            # cap_d mid-window, so the CURRENT cap_d says nothing about
            # the capacity a dropped part actually ran at.  Overflow is
            # only unrecoverable when a part dropped AT the worst-case
            # capacity; otherwise grow past the largest dropped capacity
            # and replay (strict growth per iteration -> termination).
            raw_hi = dedup_hi = 0
            for p, d in zip(self.pending, drops.tolist()):
                if not int(d):
                    continue
                part_cap = int(p.cols[0].shape[-1]) // self.n
                if part_cap >= self._cap_limit:
                    mode = "dedup cap_d" if p.wts is not None else "raw cap"
                    raise RuntimeError(
                        f"exchange overflow at worst-case {mode}="
                        f"{part_cap}: {int(drops.sum())} entries dropped"
                    )
                if p.wts is not None:
                    dedup_hi = max(dedup_hi, part_cap)
                else:
                    raw_hi = max(raw_hi, part_cap)
            if raw_hi:
                self.cap = min(max(self.cap, raw_hi) * 2, self._cap_limit)
                self._exchange = self._build_exchange()
            if dedup_hi:
                self.cap_d = min(
                    max(self.cap_d, dedup_hi) * 2, self._cap_limit
                )
                self._cap_d_floor = self.cap_d  # retunes may not undo this
                self._exchange_dedup = None
            self.n_retries += 1
            window = self._window
            self.pending = []
            self._window = []
            self._pend_ub = 0
            self.rows = 0
            for sharded, sids, pos, use_dedup in window:
                mode_cap = self.cap_d if use_dedup else self.cap
                uniq_charge = min(pos, self.n * mode_cap)
                # fresh conservative charge; the original feed's (smaller)
                # charge stays — overcounting _wt_dev only spills earlier
                self._wt_dev += pos
                self._ensure_room(uniq_charge)
                self._dispatch(sharded, sids, use_dedup, pos)
                self._window.append((sharded, sids, pos, use_dedup))
                self._pend_ub += uniq_charge

    def _stats(self) -> dict:
        """Counters of merges completed so far (pending parts excluded);
        usually already prefetched by the post-merge async copies."""
        return {
            "n_unique": np.asarray(self.state.n_unique).tolist(),
            "dropped": int(np.asarray(self.state.dropped)),
            "overflow": int(np.asarray(self.state.overflow)),
        }

    def check(self) -> dict:
        """Flush pending parts into the accumulator, then return the
        capacity counters.  NOTE: this forces a merge (one weighted sort +
        one compaction sort, possibly at a sub-fanin part count) — poll
        sparingly; the counters themselves are prefetched and cheap."""
        self._merge_pending()
        return self._stats()

    def _raise_if_lost(self, stats: dict) -> None:
        if stats["dropped"]:
            raise RuntimeError(
                f"exchange overflow: {stats['dropped']} entries; raise cap"
            )
        if stats["overflow"]:
            raise RuntimeError(
                f"accumulator overflow: {stats['overflow']} uniques; raise acc_cap"
            )

    def spill(self) -> None:
        """Pull the accumulated per-chip tables to the host and reset the
        device accumulator — the pressure valve that makes acc_cap a budget,
        not a limit."""
        stats = self.check()
        self._raise_if_lost(stats)
        self.host_spills.extend(self._pull_tables(stats))
        self.state = self._init_state()
        self._acc_ub = 0
        self._wt_dev = 0  # spilled weights left the device (pending is empty)
        self.materialize_spills(block=False)  # free landed spills
        self._bound_inflight()

    def _pull_tables(self, stats: dict) -> list:
        """Per-chip table pulls, ASYNC: each chip's device slice is returned
        with its D2H copy merely started; entries materialize to numpy
        lazily (materialize_spills) so spills overlap the continuing feed
        instead of stalling it for the whole transfer."""
        if not any(stats["n_unique"]):
            return []
        if self._stack is None:
            self._stack = _build_stack_all(self.mesh, self.k, self.m, self.B, self.Wk)
        stacked = self._stack(self.state.words, self.state.wts)
        parts = []
        # per-chip pulls via addressable shards (indexing a sharded axis in
        # the global view would require ambiguous-sharding gathers); the
        # chip id comes from the shard's GLOBAL index — on a multi-host
        # mesh this process only addresses a subset of chips
        for shard in stacked.addressable_shards:
            c = shard.index[0].start or 0
            u = stats["n_unique"][c]
            if u == 0:
                continue
            sl = shard.data[0, :u]  # device-side slice
            sl.copy_to_host_async()
            parts.append(_PendingSpill(sl, c))
        return parts

    def _to_np_spill(self, s) -> tuple:
        tab = np.asarray(s.data if isinstance(s, _PendingSpill) else s)
        return (
            tab[:, : self.W], tab[:, self.W].astype(np.int64),
            tab[:, self.W + 1].astype(np.int32),
        )

    def materialize_spills(self, block: bool = True) -> None:
        """Convert pending device-side spill slices to numpy tuples;
        block=False converts only already-landed transfers.  Must be called
        with block=True before persisting host_spills to a checkpoint."""
        for i, s in enumerate(self.host_spills):
            if not isinstance(s, _PendingSpill):
                continue
            if not block and not s.data.is_ready():
                continue
            self.host_spills[i] = self._to_np_spill(s)

    # at most this many SPILLS' worth of slices may be in flight PER CHIP
    # (device buffers alive, D2H unlanded) before older slices are
    # force-materialized — per chip, because under bin skew every pending
    # slice can sit on one chip, and the bound exists to cap the pinned
    # acc_cap-row buffers in that chip's HBM (ADVICE r3).  The bound holds
    # after each spill completes (post-append): a spill may transiently
    # observe MAX+1 inside _bound_inflight before the oldest lands.
    MAX_INFLIGHT_SPILLS = 2

    def _bound_inflight(self) -> None:
        by_chip: dict[int, list[int]] = {}
        for i, s in enumerate(self.host_spills):
            if isinstance(s, _PendingSpill):
                by_chip.setdefault(s.chip, []).append(i)
        for pend in by_chip.values():
            for i in pend[: max(0, len(pend) - self.MAX_INFLIGHT_SPILLS)]:
                self.host_spills[i] = self._to_np_spill(self.host_spills[i])

    def finalize(self):
        """-> (words [U, W], counts [U], bins [U]) merged across chips.

        Bins partition k-mers across chips, so per-chip tables are disjoint
        and spills never share k-mers with later tables *of other chips*;
        the same chip may spill the same k-mer twice, so the host merge is
        a weighted group-by (pipeline.merge_partials).  One stacked D2H per
        chip per spill.
        """
        stats = self.check()
        self._raise_if_lost(stats)
        from .. import pipeline as base

        parts = self.host_spills + self._pull_tables(stats)
        parts = [
            p if isinstance(p, tuple) else self._to_np_spill(p) for p in parts
        ]
        if not parts:
            return (
                np.zeros((0, self.W), np.uint32),
                np.zeros(0, np.int64),
                np.zeros(0, np.int32),
            )
        return base.merge_partials(parts, self.W)


# module-level cache: one trace per (mesh, k, m, B, Wk) across
# DistributedCounter instances — instances share stacks like they share
# merges (_merge_cache bounds compiles per instance; this bounds them
# globally).
_STACK_CACHE: dict[tuple, callable] = {}


def _build_stack_all(mesh: Mesh, k: int, m: int, B: int, Wk: int):
    """jit fn: [n, acc_cap, W] words + [n, acc_cap] wts -> [n, acc_cap, W+2]
    uint32 with bins appended.  A shard_map: bins are recomputed per chip
    from its own words (no cross-shard reshape — a global-view reshape over
    the sharded axis both moves data and, under explicit-sharding meshes,
    produces concat operands with mismatched shardings).

    ``Wk`` = k-mer word count; bins are a function of the k-mer words only
    (any trailing seq lane is excluded from the hash)."""
    key = (mesh, k, m, B, Wk)
    if key in _STACK_CACHE:
        return _STACK_CACHE[key]

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS))
    def stack(words, wts):
        flat = words[0]  # [acc_cap, W] local
        bins = binhash.bins_from_words(flat[:, :Wk], k, m, B)
        return jnp.concatenate(
            [flat, wts[0][:, None].astype(jnp.uint32), bins[:, None].astype(jnp.uint32)],
            axis=1,
        )[None]

    fn = jax.jit(stack)
    _STACK_CACHE[key] = fn
    return fn
