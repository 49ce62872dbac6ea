"""Multisequence k-mer counting with pairwise distances (the L5 extension).

Re-design of ``SparkMultiSequenceKmerCounter`` (reference:
src/main/scala/skc/multisequence/SparkMultiSequenceKmerCounter.scala): reads
carry a sequence id; per-bin counting produces per-(k-mer, sequence) count
vectors; every distinct k-mer updates all pairwise distances with
``partial(c[s1], c[s2])``; count output per bin is the per-k-mer SUM over
sequences (:487, :524 — identical to the single-sequence output format).

Deliberate fixes over the reference (SURVEY.md §2.5):

* the pair loop used inclusive ``s1+1 to length`` and overran by one
  (:453, :475, :513); here pairs are s2 in (s1, S) — corrected.
* sequence names come from each record's own FASTA header (first token),
  not the first read of a partition (:61-62 limitation).
* partial distances are actually aggregated across bins/chips and saved
  (the reference returned them from mapPartitions and dropped them,
  README.md:126 "not yet aggregated").

Device-side trick: the sequence id rides as ONE EXTRA KEY WORD through the
existing sort-count engine (runs become (k-mer, seq) pairs), so multiseq
counting reuses count_sort verbatim; the O(U·S) pairwise accumulation runs
vectorized on the host over the final unique table.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import JobConfig
from ..core.bits import num_words
from ..ingest import fasta
from ..ops import count_sort, extract
from ..output import writer
from ..utils.timing import StageTimer
from . import distances as dist_mod


@dataclasses.dataclass
class MultiseqConfig(JobConfig):
    """MultisequenceTestConfiguration equivalent
    (reference: multisequence/package.scala:25-35)."""

    distance_measure: str = "multisequence.SquaredEuclidean"


class MultiseqResult(NamedTuple):
    words: np.ndarray  # [U, W] unique canonical k-mers (ascending)
    seqs: np.ndarray  # [U] sequence id per row (k-mer repeats per seq)
    counts: np.ndarray  # [U] int64
    bins: np.ndarray  # [U] int32
    sequence_names: list
    distances: dict  # (name1, name2) -> float, ordered pairs per symmetry
    n_instances: int
    timings: dict
    exchange_bytes: int = 0  # distributed runs: per-chip bytes over the interconnect
    balance: dict | None = None  # distributed runs: LPT pre-pass stats


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_count_seq(codes: jnp.ndarray, seq_ids: jnp.ndarray, k: int, m: int, B: int):
    """Count (k-mer, sequence) pairs: seq id appended as an extra key word.

    The extra column never equals the all-ones sentinel for valid rows, so
    sentinel-safe sorting applies for every k.
    """
    from ..ops import binhash

    ex = extract.extract(codes, k, m, B)
    R, L = codes.shape
    P = L - k + 1
    seq_col = jnp.broadcast_to(seq_ids[:, None].astype(jnp.uint32), (R, P)).reshape(R * P, 1)
    words_ext = jnp.concatenate([ex.words, seq_col], axis=1)
    sc = count_sort.count_sorted(words_ext, None, ex.valid, sentinel_safe=True)
    W = ex.words.shape[1]
    return sc._replace(bins=binhash.bins_from_words(sc.words[:, :W], k, m, B))


@partial(jax.jit, static_argnames=("k", "m", "B"))
def _batch_extract_keys_seq(codes: jnp.ndarray, seq_ids: jnp.ndarray, k: int, m: int, B: int):
    """Stage-1 only, multiseq flavor: pre-sentineled (k-mer words, seq id)
    key columns with NO per-batch sort — the device accumulator's fan-in
    merge does all the sorting (pipeline._batch_extract_keys + the seq-lane
    trick from parallel.stream).  The seq lane makes the row sentinel-safe
    for every k: a valid row's last lane is a seq id < 2^31."""
    ones = jnp.uint32(0xFFFFFFFF)
    R, L = codes.shape
    P = L - k + 1
    ex = extract.extract(codes, k, m, B)
    valid = ex.valid
    W = ex.words.shape[1]
    cols = tuple(jnp.where(valid, ex.words[:, w], ones) for w in range(W))
    seq_col = jnp.broadcast_to(seq_ids[:, None].astype(jnp.uint32), (R, P)).reshape(R * P)
    return cols + (jnp.where(valid, seq_col, ones),)


# one compiled kernel per (measure, S, T): the measure's row terms are
# closed over (elementwise jnp), so the whole block loop jits once
_PAIR_JIT: dict = {}

# Auto-selection stays on the host path: the final table lives on the
# HOST after finalize (spill merging), so the device arm pays H2D every
# call.  Whether it pays on the H100 is not yet measured; device=True is
# the explicit override.


def _pair_sums_device_fn(measure: dist_mod.DistanceMeasure, S: int, T: int = 2048):
    """Build the jitted device pair-sum kernel: D[a, b] = sum over
    same-k-mer ordered row pairs (i, j) of f(c_i) * g(c_j) at
    [seq_i, seq_j] — the Gram accumulation of ``bilinear_terms`` WITHOUT
    the dense [groups, S] matrix (whose construction is a scatter, and
    whose H2D shipping would dwarf the matmul).

    Formulation: rows arrive sorted by (k-mer, seq) with (group, seq)
    unique, so a group spans at most S consecutive rows.  Process T-row
    blocks with an S-row halo on each side; per block the same-group mask
    P = (gid_core == gid_window) is exact, and the S x S contribution is
    two matmuls: onehot_f.T @ (P @ onehot_g).  Every ordered pair is
    anchored at its i row's core block, so nothing is double-counted.
    O(N*(T+2S)*S) f32 flops vs the host path's O(groups*S^2) f64 BLAS.

    f32 caveat: exact for counts < 2^24; products accumulate in f32.  The
    matmuls ask for ``Precision.HIGHEST`` — at default precision a GPU
    runs f32 matmuls in TF32 (~3 decimal digits), which would break the
    bound below.  The result matches the host f64 path to rtol 1e-4 for
    SquaredEuclidean, and to rtol 2e-4 for measures whose terms cancel
    (c*log c - c*log c' in KLD): the f32 accumulation sets the bound.

    Reference semantics: the streaming pairwise accumulation of
    extractKXmersAndComputePartialDistances
    (SparkMultiSequenceKmerCounter.scala:446-520), reduced to matmuls.
    """
    key = (measure.name, S, T)
    fn = _PAIR_JIT.get(key)
    if fn is not None:
        return fn

    @jax.jit
    def pair_sums(gid: jnp.ndarray, seqs: jnp.ndarray, counts: jnp.ndarray):
        N = gid.shape[0]
        terms = measure.bilinear_row_terms(counts)
        valid = gid >= 0
        # mask AFTER evaluation: padded rows have count 0, where f may be
        # nan (e.g. 0*log 0) — jnp.where selects the 0 branch regardless
        terms = [
            (jnp.where(valid, f, 0.0), jnp.where(valid, g, 0.0))
            for f, g in terms
        ]
        ext_gid = jnp.pad(gid, (S, S), constant_values=-1)
        ext_seq = jnp.pad(seqs, (S, S))
        ext_g = [jnp.pad(g, (S, S)) for _, g in terms]
        eye = jnp.arange(S, dtype=jnp.int32)

        def body(D, b):
            start = b * T
            wgid = jax.lax.dynamic_slice(ext_gid, (start,), (T + 2 * S,))
            wseq = jax.lax.dynamic_slice(ext_seq, (start,), (T + 2 * S,))
            cgid = jax.lax.dynamic_slice(gid, (start,), (T,))
            cseq = jax.lax.dynamic_slice(seqs, (start,), (T,))
            Pm = (
                (cgid[:, None] == wgid[None, :]) & (cgid[:, None] >= 0)
            ).astype(jnp.float32)
            for (f, _), g_ext in zip(terms, ext_g):
                fc = jax.lax.dynamic_slice(f, (start,), (T,))
                gw = jax.lax.dynamic_slice(g_ext, (start,), (T + 2 * S,))
                Fo = fc[:, None] * (cseq[:, None] == eye[None, :])
                Go = gw[:, None] * (wseq[:, None] == eye[None, :])
                hi = jax.lax.Precision.HIGHEST
                D = D + jnp.matmul(
                    Fo.T, jnp.matmul(Pm, Go, precision=hi), precision=hi
                )
            return D, None

        D, _ = jax.lax.scan(
            body, jnp.zeros((S, S), jnp.float32),
            jnp.arange(N // T, dtype=jnp.int32),
        )
        return D

    _PAIR_JIT[key] = pair_sums
    return pair_sums


def accumulate_distances(
    words: np.ndarray,
    seqs: np.ndarray,
    counts: np.ndarray,
    S: int,
    measure: dist_mod.DistanceMeasure,
    device: bool | None = None,
) -> np.ndarray:
    """D[a, b] = sum over distinct k-mers of partial(c_a, c_b), rows sorted
    by (k-mer, seq).

    Identity used (both paths): with tot_a = sum_k partial(c_a, 0) over all
    k-mers present in a (and tot_b the 0-left analogue),

        D[a, b] = tot_a[a] + tot_b[b]
                + sum over same-k-mer present pairs of
                  h(c_a, c_b) = partial(c_a,c_b) - partial(c_a,0) - partial(0,c_b)

    When the measure decomposes h bilinearly (bilinear_terms), the pair sum
    is blocked dense [groups, S] count matrices reduced by F.T @ G Gram
    matmuls — O(U*S) BLAS flops, no pairwise sweep; otherwise the generic
    neighbor-offset sweep below handles arbitrary plug-in measures.
    """
    U = words.shape[0]
    D = np.zeros((S, S), np.float64)
    if U == 0:
        if measure.operator_kind != "sum":
            D[:] = measure.init_distance()
            np.fill_diagonal(D, 0.0)
        return D
    counts = counts.astype(np.float64)
    kchange = np.empty(U, dtype=bool)
    kchange[0] = True
    np.any(words[1:] != words[:-1], axis=1, out=kchange[1:])
    gid = np.cumsum(kchange) - 1  # k-mer group id per row

    # --- operator-generic fold (non-additive distanceOperator plug-ins,
    # DistanceMeasure.java:16-40): every identity below — tot_a + tot_b +
    # pair corrections, bilinear Gram products — is a SUM decomposition,
    # so non-sum measures take the direct fold the reference merge loop
    # performs (d = op(d, partial(c1, c2)) per distinct k-mer,
    # SparkMultiSequenceKmerCounter.scala:474-482): dense [g, S] count
    # blocks, partial evaluated on [g, S, S], folded with the operator.
    # O(G*S^2) — the reference's own cost for these measures. ---
    if measure.operator_kind != "sum":
        D[:] = measure.init_distance()
        starts = np.flatnonzero(kchange)
        bounds = np.append(starts, U)
        n_groups = starts.size
        group_block = max(1, (1 << 18) // max(S * S, 1))
        for b0 in range(0, n_groups, group_block):
            b1 = min(b0 + group_block, n_groups)
            lo, hi = bounds[b0], bounds[b1]
            C = np.zeros((b1 - b0, S), np.float64)
            C[gid[lo:hi] - b0, seqs[lo:hi]] = counts[lo:hi]
            Pm = measure.partial(C[:, :, None], C[:, None, :])  # [g, S, S]
            if measure.operator_kind == "product":
                D *= np.prod(Pm, axis=0)
            else:
                for g in range(Pm.shape[0]):  # ordered left fold
                    D = measure.operator(D, Pm[g])
        np.fill_diagonal(D, 0.0)
        return D

    # device Gram path: matmuls over the table rows.  ``device=None``
    # resolves to HOST: the post-finalize table is host-resident and must
    # ship.  ``device=True`` forces it (valid when counts are f32-exact,
    # <2^24); result matches host to rtol 1e-4 (2e-4 for KLD-like
    # measures, see _pair_sums_device_fn).
    has_row = (
        type(measure).bilinear_row_terms
        is not dist_mod.DistanceMeasure.bilinear_row_terms
    )
    if device is None:
        device = False
    if device and has_row:
        D = _pair_sums_from_device(gid, seqs, counts, S, measure)
        zero = np.zeros_like(counts)
        D += np.bincount(seqs, weights=measure.partial(counts, zero), minlength=S)[:, None]
        D += np.bincount(seqs, weights=measure.partial(zero, counts), minlength=S)[None, :]
        np.fill_diagonal(D, 0.0)
        return D

    if measure.bilinear_terms(np.zeros((0, S), np.float64)) is not None:
        starts = np.flatnonzero(kchange)  # entry index of each group start
        n_groups = starts.size
        bounds = np.append(starts, U)
        # ~8 MB float64 per dense block
        group_block = max(1, (1 << 20) // max(S, 1))
        for b0 in range(0, n_groups, group_block):
            b1 = min(b0 + group_block, n_groups)
            lo, hi = bounds[b0], bounds[b1]
            C = np.zeros((b1 - b0, S), np.float64)
            C[gid[lo:hi] - b0, seqs[lo:hi]] = counts[lo:hi]
            for F, G in measure.bilinear_terms(C):
                D += F.T @ G
        zero = np.zeros_like(counts)
        D += np.bincount(seqs, weights=measure.partial(counts, zero), minlength=S)[:, None]
        D += np.bincount(seqs, weights=measure.partial(zero, counts), minlength=S)[None, :]
        np.fill_diagonal(D, 0.0)
        return D

    # generic fallback: joint-present pairs via neighbor offsets within
    # k-mer groups (each group has <= S rows)
    joint_partial = np.zeros((S, S), np.float64)  # sum partial(ci, cj) over joint
    joint_single_a = np.zeros((S, S), np.float64)  # sum partial(ci, 0) over joint
    joint_single_b = np.zeros((S, S), np.float64)  # sum partial(cj, 0) over joint
    zeros = np.zeros(1, np.float64)
    for o in range(1, S):
        if o > U - 1:
            break
        same = gid[o:] == gid[:-o]
        if not same.any():
            continue
        a, b = seqs[:-o][same], seqs[o:][same]
        ca, cb = counts[:-o][same], counts[o:][same]
        np.add.at(joint_partial, (a, b), measure.partial(ca, cb))
        np.add.at(joint_partial, (b, a), measure.partial(cb, ca))
        np.add.at(joint_single_a, (a, b), measure.partial(ca, zeros))
        np.add.at(joint_single_a, (b, a), measure.partial(cb, zeros))
        np.add.at(joint_single_b, (a, b), measure.partial(zeros, cb))
        np.add.at(joint_single_b, (b, a), measure.partial(zeros, ca))

    # totals of one-sided terms over ALL rows of each sequence
    tot_a = np.zeros(S, np.float64)  # sum partial(c, 0)
    tot_b = np.zeros(S, np.float64)  # sum partial(0, c)
    np.add.at(tot_a, seqs, measure.partial(counts, np.zeros_like(counts)))
    np.add.at(tot_b, seqs, measure.partial(np.zeros_like(counts), counts))

    # D[a,b] = joint pairs + (a-only terms) + (b-only terms)
    D = joint_partial + (tot_a[:, None] - joint_single_a) + (tot_b[None, :] - joint_single_b)
    np.fill_diagonal(D, 0.0)
    return D


def _pair_sums_from_device(gid, seqs, counts, S, measure, T: int = 2048):
    """Host shim for the device kernel: pad the table to a T granule
    (sentinel gid=-1 rows contribute 0), ship the three thin columns once
    (N*12 bytes — vs the dense [groups, S] blocks the host path builds),
    run the jitted block scan, pull back one [S, S] f32 matrix."""
    assert S <= T, (S, T)
    N = gid.shape[0]
    Np = -(-N // T) * T
    g = np.full(Np, -1, np.int32)
    g[:N] = gid
    sq = np.zeros(Np, np.int32)
    sq[:N] = seqs
    c = np.zeros(Np, np.float32)
    c[:N] = counts
    fn = _pair_sums_device_fn(measure, S, T)
    return np.asarray(
        fn(jnp.asarray(g), jnp.asarray(sq), jnp.asarray(c))
    ).astype(np.float64)


def _sequence_tag(header: str) -> str:
    """Sequence name from a read header: the leading word-character run,
    matching the reference's ``"(\\w+)."`` extraction
    (SparkMultiSequenceKmerCounter.scala:61-62) — SRA-style reads
    ``SRR197985.1``, ``SRR197985.2`` tag the same sequence ``SRR197985``.
    Chunk suffixes (``#i``) from long-mode splitting are stripped first."""
    import re as _re

    head = header.split("#")[0]
    mobj = _re.match(r"(\w+)", head)
    return mobj.group(1) if mobj else head.split()[0]


def execute_multiseq_job(
    cfg: MultiseqConfig,
    verbose: bool = True,
    device_accumulate: bool | None = None,
    unique_ub: int | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_interval: int = 32,
    keep_table: bool = False,
) -> MultiseqResult:
    """Single-chip multiseq job on the counting path's machinery: tagged
    DENSE row packing (multiple reads per row, one sequence per row —
    ingest._TaggedDensePacker), the stage-1 extractor, and deferred device-resident accumulation (pipeline.DeviceAccumulator
    with the seq id as one extra key lane).  Reference semantics:
    SparkMultiSequenceKmerCounter.scala:300-547.

    ``checkpoint_dir`` enables kill-and-resume exactly like the count job
    (manifest.BatchCheckpointer): the accumulator path persists forced
    spills at interval boundaries, the host-merge path persists per-batch
    parts.  Spilled (k-mer, seq) rows carry the seq lane in the npz, so
    resume re-enters the same weighted merge; sequence names are rebuilt
    deterministically by re-scanning the skipped reads (first-seen order)."""
    from .. import pipeline as base
    from ..ingest import batch as batching
    from ..ingest.prefetch import prefetched
    from ..output import manifest as manifest_mod

    timer = StageTimer()
    measure = dist_mod.get_measure(cfg.distance_measure)
    if verbose:
        print(cfg.describe())

    # ingest with per-record sequence ids
    seq_names: list[str] = []
    name_to_id: dict[str, int] = {}

    def tagged_reads():
        for name, seq in fasta.iter_reads(cfg.dataset, cfg.sequence_type, cfg.k, cfg.read_len):
            base_name = _sequence_tag(name)
            if base_name not in name_to_id:
                name_to_id[base_name] = len(seq_names)
                seq_names.append(base_name)
            yield name_to_id[base_name], seq

    W = num_words(cfg.k)
    if device_accumulate is None:
        # unique_ub is an accumulator contract (sync-free feed): honoring
        # it means taking the accumulator path on every backend
        device_accumulate = unique_ub is not None or jax.default_backend() != "cpu"
    acc = (
        base.DeviceAccumulator(
            cfg.k, m=cfg.m, B=cfg.b, extra_lanes=1, unique_ub=unique_ub
        )
        if device_accumulate
        else None
    )
    parts = []
    ckpt = (
        manifest_mod.BatchCheckpointer(checkpoint_dir, checkpoint_interval)
        if checkpoint_dir
        else None
    )
    skip = 0
    persisted = 0
    if ckpt is not None:
        skip = ckpt.completed_batches()
        loaded = ckpt.load_parts()
        if acc is not None:
            acc.host_spills.extend(loaded)
            persisted = len(acc.host_spills)
        else:
            parts.extend(loaded)
    batches = prefetched(
        batching.batch_codes_dense_tagged(
            tagged_reads(), cfg.reads_per_batch, cfg.read_len
        )
    )
    with timer.span("device_count"):
        for batch_idx, (codes, sids, _, _) in enumerate(batches):
            if batch_idx < skip:
                continue  # counted before the interruption (names rebuilt)
            if acc is not None:
                acc.add_raw(
                    _batch_extract_keys_seq(
                        jnp.asarray(codes), jnp.asarray(sids),
                        cfg.k, cfg.m, cfg.b,
                    )
                )
                if ckpt is not None and (batch_idx + 1) % ckpt.interval == 0:
                    acc._merge_pending()
                    stats = acc._stats()
                    acc._raise_if_lost(stats)
                    acc._spill(stats)
                    acc.materialize_spills(block=True)  # persist = landed
                    ckpt.save_spills(
                        batch_idx + 1, acc.host_spills[persisted:], persisted
                    )
                    persisted = len(acc.host_spills)
            else:
                sc = _batch_count_seq(
                    jnp.asarray(codes), jnp.asarray(sids), cfg.k, cfg.m, cfg.b
                )
                part = base._compact(sc)
                parts.append(part)
                if ckpt is not None:
                    ckpt.save_batch(batch_idx, *part)

    with timer.span("merge"):
        if acc is not None:
            words_ext, counts, bins = acc.finalize()
        elif parts:
            words_ext, counts, bins = base.merge_partials(parts, W + 1)
        else:
            words_ext = np.zeros((0, W + 1), np.uint32)
            counts = np.zeros(0, np.int64)
            bins = np.zeros(0, np.int32)
    words = words_ext[:, :W]
    seqs = words_ext[:, W].astype(np.int32)

    S = len(seq_names)
    with timer.span("distances"):
        D = accumulate_distances(words, seqs, counts, S, measure) if S else np.zeros((0, 0))
        pair_dist = {}
        for s1 in range(S):
            for s2 in range(s1 + 1, S):  # corrected: exclusive upper bound
                pair_dist[(seq_names[s1], seq_names[s2])] = measure.finalize(
                    float(D[s1, s2]), 0
                )
                if not measure.symmetric:
                    pair_dist[(seq_names[s2], seq_names[s1])] = measure.finalize(
                        float(D[s2, s1]), 0
                    )

    if cfg.write:
        with timer.span("write_output"):
            _write_multiseq_output(cfg, words, counts, bins, pair_dist, measure,
                                   keep_table=keep_table)
    if ckpt is not None:
        ckpt.clear()  # run completed

    return MultiseqResult(
        words, seqs, counts, bins, seq_names, pair_dist, int(counts.sum()), timer.as_dict()
    )


def _write_multiseq_output(cfg, words, counts, bins, pair_dist, measure,
                           keep_table: bool = False) -> None:
    """Bin files (per-k-mer SUM over sequences,
    SparkMultiSequenceKmerCounter.scala:487) + distances.json + a manifest
    whose extra_files entry checksums the distances — so verify_output
    covers a multiseq directory completely (VERDICT r2 weak #8).

    ``use_kryo_serializer`` selects the binary format like the count job
    (the reference multiseq CLI parses useKryo but silently drops it,
    TestMultisequenceKmerCounter.scala:42 — here it takes effect)."""
    import dataclasses

    from ..output import manifest as manifest_mod

    uw, uc, ub = _sum_over_sequences(words, counts, bins)
    dpath = _write_distances(cfg.output_dir, pair_dist, measure)
    dist_extra = {"distances.json": manifest_mod.file_sha256(dpath)}
    cfg_dict = {
        key: v for key, v in dataclasses.asdict(cfg).items() if not callable(v)
    }
    if cfg.use_kryo_serializer:
        writer.write_binary_with_manifest(
            cfg.output_dir, cfg_dict, uw, uc, ub, cfg.k,
            extra_files=dist_extra,
        )
    else:
        hashes = writer.write_bin_files(cfg.output_dir, uw, uc, ub, cfg.k)
        manifest_mod.write_manifest(
            cfg.output_dir, cfg_dict, uw, uc, ub,
            extra_files=dist_extra, bin_hashes=hashes,
        )
    if keep_table:
        # the summed table is what the bin files render, so the sidecar's
        # checksum matches the manifest and repair_output can rewrite
        # damaged bins without recounting (the distances.json sibling is
        # verified, not repairable — it needs the per-seq table)
        manifest_mod.write_table_sidecar(cfg.output_dir, uw, uc, ub)


def _sum_over_sequences(words, counts, bins):
    if words.shape[0] == 0:
        return words, counts, bins
    new = np.empty(words.shape[0], dtype=bool)
    new[0] = True
    np.any(words[1:] != words[:-1], axis=1, out=new[1:])
    starts = np.flatnonzero(new)
    return words[starts], np.add.reduceat(counts, starts), bins[starts]


def _write_distances(out_dir: str, pair_dist: dict, measure) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "distances.json")
    with open(path, "w") as f:
        json.dump(
            {
                "measure": measure.name,
                "symmetric": measure.symmetric,
                "distances": [
                    {"seq1": a, "seq2": b, "distance": d} for (a, b), d in pair_dist.items()
                ],
            },
            f,
            indent=2,
        )
    return path
