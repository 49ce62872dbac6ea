"""Distributed bin exchange — the device-native replacement for the Spark
shuffle (reference: ``reduceByKey``/``partitionBy`` at
SparkBinKmerCounter.scala:1031-1044).

Design (SURVEY.md §5 "Distributed communication backend"):

* reads are data-parallel over a 1-D device mesh axis ("data"), the
  analogue of HDFS-split parallelism (SparkBinKmerCounter.scala:1032);
* every chip extracts (bin, canonical k-mer) entries locally, then routes
  each entry to its bin's *owner chip* through one padded
  ``lax.all_to_all`` over the interconnect — arbitrary-size JVM shuffle payloads become
  fixed-capacity uint32 lanes;
* the owner table is either ``bin % n`` (hash partitioning) or the LPT map
  from the sampled histogram pre-pass (parallel.partitioner), closed over
  as a jit constant — the device-side ``Partitioner``;
* per-chip bin histograms are exchanged with ``psum`` (the analogue of the
  estimate job's ``reduceByKey(_+_).collect()``, :1024);
* overflowed capacity is *detected, never silent*: the step returns a
  psum'd dropped-entry count so the host can retry with a bigger ``cap``
  (the moral equivalent of Spark spilling, made explicit).

Grouping entries for the send buffer is sort-based (sort by owner) and the
send-slot placement is a gather, so the whole step is scatter-free.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import count_sort, extract

AXIS = "data"


class ShardCounts(NamedTuple):
    """Per-chip counting result, stacked over the mesh axis.

    words:    [n, S, W]  sorted unique-run view per chip (S = n*cap slots)
    bins:     [n, S]
    is_uniq:  [n, S]
    counts:   [n, S]
    n_valid:  [n]        counted instances per chip
    dropped:  []         total entries dropped by capacity overflow (global)
    collision:[]         HT engine: fingerprint collisions detected (global;
                         always 0 for the sort engine)
    """

    words: jnp.ndarray
    bins: jnp.ndarray
    is_uniq: jnp.ndarray
    counts: jnp.ndarray
    n_valid: jnp.ndarray
    dropped: jnp.ndarray
    collision: jnp.ndarray


def route_by_owner(owner, valid, cols: tuple, n: int, cap: int,
                   fills: tuple | None = None):
    """Group local rows by destination chip into [n*cap] buffers.

    ``cols`` is a tuple of 1-D arrays riding along; rows where ``valid`` is
    False are discarded.  Returns (routed cols tuple, ok uint32 [n*cap],
    n_dropped scalar).  Sort-based grouping (no data-dependent shapes): one
    1-key sort by owner, then a rank-computed scatter to strided slots.

    ``fills`` (scalar per column) sets the value of UNFILLED slots (default
    0).  Filling the sort sentinel / a zero weight directly makes the ok
    lane redundant on sentinel-safe paths: the caller can then skip its
    all_to_all entirely — one fewer uint32 lane per row over the
    interconnect (the Spark shuffle ships no per-record validity bit
    either; absence IS invalidity, SparkBinKmerCounter.scala:1035).
    """
    N = owner.shape[0]
    sort_key = jnp.where(valid, owner, n).astype(jnp.int32)
    ops = (sort_key,) + tuple(cols)
    # pow2 pad for the grouping sort (count_sort.pow2_pad_rows, measured
    # 1.20x at the per-batch shape): pad rows carry the invalid key n and
    # land in the dropped-excluded bucket, past every gatherable slot
    pad = count_sort.pow2_pad_rows(N)
    if pad:
        ops = tuple(
            jnp.concatenate(
                [o, jnp.full(pad, n if i == 0 else 0, o.dtype)]
            )
            for i, o in enumerate(ops)
        )
    sorted_ = jax.lax.sort(ops, num_keys=1, is_stable=False)
    skey = sorted_[0]
    scols = sorted_[1:]

    hist = jnp.bincount(skey, length=n + 1)[:n].astype(jnp.int32)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(hist)[:-1]])

    # gather formulation (scatter-free): output slot s = (dest d, rank r) pulls sorted row offsets[d] + r when r is
    # within d's group
    slot = jnp.arange(n * cap, dtype=jnp.int32)
    d = slot // cap
    r = slot % cap
    src = jnp.clip(offsets[d] + r, 0, N - 1)
    ok = r < hist[d]
    if fills is None:
        fills = tuple(jnp.zeros((), c.dtype) for c in scols)
    routed = tuple(
        jnp.where(ok, c[src], jnp.asarray(f, c.dtype))
        for c, f in zip(scols, fills)
    )
    buf_ok = jnp.where(ok, jnp.uint32(1), jnp.uint32(0))
    n_dropped = jnp.sum(jnp.maximum(hist - cap, 0))
    return routed, buf_ok, n_dropped


def _all_to_all(x):
    return jax.lax.all_to_all(x, AXIS, split_axis=0, concat_axis=0, tiled=True)


def build_distributed_count(mesh: Mesh, k: int, m: int, B: int, cap: int, owner_map: np.ndarray,
                            use_ht: bool = False):
    """Returns jit(step): codes [R, L] (sharded over rows) -> ShardCounts.

    One fused device program per chip: extract -> route -> all_to_all ->
    per-chip count of owned bins.  ``cap`` is the per-(src,dst) entry
    capacity.

    ``use_ht`` selects the HT engine (useHT=1) on the received rows —
    fingerprint-keyed counting (ops.count_hash), completing the reference
    orchestrator's 2x2 {sort,HT} x {hash,LPT} matrix on the mesh
    (SparkBinKmerCounter.scala:1031-1044).  Collisions are psum'd into
    ShardCounts.collision; the driver checks once at finalize (they exist
    to be astronomically rare — no per-batch device sync).

    The owner table rides as a replicated *argument*, not a closure
    constant: jax materializes closed-over device arrays during lowering.
    """
    n = mesh.shape[AXIS]
    owner_arr = np.asarray(owner_map, dtype=np.int32)
    sentinel_ok = count_sort.sentinel_safe_for(k)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS, None), P()),
        out_specs=ShardCounts(
            words=P(AXIS), bins=P(AXIS), is_uniq=P(AXIS), counts=P(AXIS),
            n_valid=P(AXIS), dropped=P(), collision=P(),
        ),
    )
    def step(codes: jnp.ndarray, owner_tab: jnp.ndarray) -> ShardCounts:
        from ..ops import binhash

        ex = extract.extract(codes, k, m, B)
        W = ex.words.shape[1]
        owner = owner_tab[ex.bins]
        # no bin lane: the owner recomputes bins from the words it receives
        cols = tuple(ex.words[:, w] for w in range(W))
        ones = jnp.uint32(0xFFFFFFFF)
        if sentinel_ok:
            # sentinel-fill the unfilled slots and pre-sentinel invalid
            # rows' words, so the ok lane never crosses the interconnect
            # (W lanes instead of W+1 per row)
            cols = tuple(jnp.where(ex.valid, c, ones) for c in cols)
            routed, _bok, ndrop = route_by_owner(
                owner, ex.valid, cols, n, cap, fills=(ones,) * W
            )
            recv = [_all_to_all(c) for c in routed]
            rw = jnp.stack(recv, axis=1)
            rok = recv[W - 1] != ones
        else:
            routed, bok, ndrop = route_by_owner(owner, ex.valid, cols, n, cap)
            # exchange: row block [d*cap:(d+1)*cap) goes to chip d
            recv = [_all_to_all(c) for c in routed] + [_all_to_all(bok)]
            rw = jnp.stack(recv[:W], axis=1)
            rok = recv[W] == jnp.uint32(1)
        if use_ht:
            from ..ops import count_hash

            sc, coll = count_hash.count_hashed(rw, None, rok)
            collision = jax.lax.psum(coll.astype(jnp.int32), AXIS)
        else:
            sc = count_sort.count_sorted(
                rw, None, rok, sentinel_safe=count_sort.sentinel_safe_for(k)
            )
            collision = jax.lax.psum(jnp.int32(0), AXIS)
        sc = sc._replace(bins=binhash.bins_from_words(sc.words, k, m, B))
        dropped = jax.lax.psum(ndrop, AXIS)
        return ShardCounts(
            words=sc.words[None], bins=sc.bins[None], is_uniq=sc.is_uniq[None],
            counts=sc.counts[None], n_valid=sc.n_valid[None], dropped=dropped,
            collision=collision,
        )

    jitted = jax.jit(step)
    return lambda codes: jitted(codes, owner_arr)


def build_distributed_count_smer(
    mesh: Mesh, k: int, m: int, B: int, cap: int, smax: int, owner_map: np.ndarray,
    use_ht: bool = False,
):
    """Super-k-mer-transport variant of build_distributed_count.

    Shuffles fixed-width super-k-mer records (smax packed bases + run length
    + bin: the reference's getSuperKmers payload, SparkBinKmerCounter.scala:34-169)
    instead of individual k-mers, then expands and counts on the owner chip
    — cutting exchange bytes by roughly the mean run length at the price of
    expansion padding in the owner-side sort.  ``cap`` counts super-k-mer
    records per (src, dst) pair.

    Extraction feeds superkmer.group from the same extractor as every other
    mesh path.  ``use_ht`` counts the
    expanded rows with the HT engine — super-k-mer shuffle + hash counting
    is literally the reference's useHT=1 shape (getSuperKmersWithBinSizes +
    extractKXmersHT, SparkBinKmerCounter.scala:290-426, 664-739).
    """
    from ..ops import superkmer

    n = mesh.shape[AXIS]
    owner_arr = np.asarray(owner_map, dtype=np.int32)
    PW = superkmer.payload_words(smax)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS, None), P()),
        out_specs=ShardCounts(
            words=P(AXIS), bins=P(AXIS), is_uniq=P(AXIS), counts=P(AXIS),
            n_valid=P(AXIS), dropped=P(), collision=P(),
        ),
    )
    def step(codes: jnp.ndarray, owner_tab: jnp.ndarray) -> ShardCounts:
        from ..ops import binhash

        sk, _ex = superkmer.group(codes, k, m, B, smax)
        owner = owner_tab[sk.bins]
        # records carry payload + run length only; bins are recomputed on
        # the owner from the expanded words.  Unfilled slots get n_kmers=0
        # (expand emits zero valid k-mers from them), so no ok lane ships.
        cols = tuple(sk.payload[:, w] for w in range(PW)) + (sk.n_kmers,)
        fills = (jnp.uint32(0xFFFFFFFF),) * PW + (jnp.zeros((), sk.n_kmers.dtype),)
        routed, _bok, ndrop = route_by_owner(
            owner, sk.is_start, cols, n, cap, fills=fills
        )
        recv = [_all_to_all(c) for c in routed]
        rpay = jnp.stack(recv[:PW], axis=1)  # [n*cap, PW]
        nk = recv[PW]
        kwords, kvalid, _kb = superkmer.expand(
            rpay, nk, jnp.zeros_like(nk), k, smax
        )
        S, C, W = kwords.shape
        if use_ht:
            from ..ops import count_hash

            sc, coll = count_hash.count_hashed(
                kwords.reshape(S * C, W), None, kvalid.reshape(S * C)
            )
            collision = jax.lax.psum(coll.astype(jnp.int32), AXIS)
        else:
            sc = count_sort.count_sorted(
                kwords.reshape(S * C, W),
                None,
                kvalid.reshape(S * C),
                sentinel_safe=count_sort.sentinel_safe_for(k),
            )
            collision = jax.lax.psum(jnp.int32(0), AXIS)
        sc = sc._replace(bins=binhash.bins_from_words(sc.words, k, m, B))
        dropped = jax.lax.psum(ndrop, AXIS)
        return ShardCounts(
            words=sc.words[None], bins=sc.bins[None], is_uniq=sc.is_uniq[None],
            counts=sc.counts[None], n_valid=sc.n_valid[None], dropped=dropped,
            collision=collision,
        )

    jitted = jax.jit(step)
    return lambda codes: jitted(codes, owner_arr)


def exchange_bytes_per_step(n: int, cap: int, k: int, smax: int | None = None) -> int:
    """Bytes crossing the interconnect per chip per step (shuffle-bytes
    accounting).  Per-k-mer transport moves
    the W key words only when the sentinel is unambiguous (k % 16 != 0 —
    unfilled slots ship as the sentinel, no ok lane), W+1 otherwise;
    super-k-mer transport moves payload + n_kmers (unfilled slots ship
    n_kmers=0)."""
    from ..core.bits import num_words
    from ..ops import superkmer

    if smax is None:
        lanes = num_words(k) + (0 if count_sort.sentinel_safe_for(k) else 1)
    else:
        lanes = superkmer.payload_words(smax) + 1  # payload + n_kmers
    return n * cap * lanes * 4


def estimate_bin_sizes(mesh: Mesh, k: int, m: int, B: int):
    """jit fn: codes [R, L] sharded -> int32[B] global per-bin k-mer counts.

    The device form of the sampled pre-pass
    (``getBinsEstimateSizes`` + ``reduceByKey(_+_).collect()``,
    SparkBinKmerCounter.scala:172-288, 1024): run it on a sampled subset of
    batches, feed the result to partitioner.lpt_owner_map.
    """
    @partial(jax.shard_map, mesh=mesh, in_specs=P(AXIS, None), out_specs=P())
    def est(codes: jnp.ndarray) -> jnp.ndarray:
        ex = extract.extract(codes, k, m, B)
        hist = count_sort.bin_histogram(ex.bins, ex.valid, B)
        return jax.lax.psum(hist, AXIS)

    return jax.jit(est)


def shard_batch(mesh: Mesh, codes: np.ndarray):
    """Place a host batch row-sharded over the mesh.

    Single-process: ``codes`` is the full [R, L] batch.  Multi-host
    (jax.process_count() > 1): ``codes`` is THIS PROCESS's row stripe of
    the global batch ([R/p, L]; see multihost.stripe_batches_padded) and
    the global array is assembled from per-process shards without any
    cross-host data movement — the ingest-sharding analogue of HDFS split
    locality.

    On the CPU backend device_put aliases the numpy buffer zero-copy, so
    the caller must not mutate ``codes`` after this call."""
    sharding = NamedSharding(mesh, P(AXIS, None))
    if jax.process_count() > 1:
        return jax.make_array_from_process_local_data(sharding, codes)
    return jax.device_put(codes, sharding)


def shard_vector(mesh: Mesh, vec: np.ndarray):
    """Place a per-row host vector (e.g. multiseq seq ids) sharded over the
    mesh axis; multi-host processes pass their local stripe."""
    sharding = NamedSharding(mesh, P(AXIS))
    if jax.process_count() > 1:
        return jax.make_array_from_process_local_data(sharding, vec)
    return jax.device_put(vec, sharding)


def compact_shard_counts(sc: ShardCounts, with_chips: bool = False):
    """Host: ShardCounts -> list per ADDRESSABLE chip of (words, counts,
    bins) uniques.  Addressable shards, not a global fetch: on a multi-host
    mesh each process compacts only its own chips' tables (bins partition
    k-mers across chips, so per-process outputs are disjoint and union to
    the full result — the Spark-executor-writes-its-partitions analogue).

    ``with_chips`` returns (global chip id, part) pairs instead — the
    per-batch driver keys its merge state by global chip so checkpointed
    parts (whose chip is recomputed as owner_map[bins]) re-enter the same
    per-chip merge on resume."""

    def shards(arr):
        return {
            s.index[0].start or 0: np.asarray(s.data)
            for s in arr.addressable_shards
        }

    w, b, u, c = map(shards, (sc.words, sc.bins, sc.is_uniq, sc.counts))
    out = []
    for chip in sorted(w):
        idx = np.flatnonzero(u[chip][0])
        part = (w[chip][0][idx], c[chip][0][idx].astype(np.int64), b[chip][0][idx])
        out.append((chip, part) if with_chips else part)
    return out
