"""Observability / debug jobs — the oracle-style tools the reference used
in place of assertions (SURVEY.md §4).

* ``find_bin_signatures`` — per-bin histogram of signature -> #super-k-mers,
  the device form of ``executeFindBinSignaturesJob`` / ``getBinSignatures`` /
  ``saveBinSignatures`` (SparkBinKmerCounter.scala:772-986): the skew
  analysis tool.  Output format matches: one ``bin_signatures<N>.txt`` per
  bin with ``<SIGNATURE>\\t<count>`` lines and a ``Total\\t<sum>`` footer.
* ``evaluate_partition_balance`` — per-partition (bin, size) dump, the
  structured form of ``evaluatePartitionBalance`` (:742-767).
"""

from __future__ import annotations

import os
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial as _partial

from .config import JobConfig
from .core import bits
from .ingest import batch as batching
from .ops import superkmer


@_partial(jax.jit, static_argnames=("k", "m", "B", "smax"))
def _sig_histogram_batch(codes, k: int, m: int, B: int, smax: int):
    """Unique (signature) -> #super-k-mer-records, via sort-count on the
    signature value of each run start."""
    from .ops import count_sort

    sk, ex = superkmer.group(codes, k, m, B, smax)
    sigs = ex.sigs[:, None]  # signature as a 1-word key
    return count_sort.count_sorted(sigs, sk.bins, sk.is_start)


def find_bin_signatures(cfg: JobConfig, smax: int = 64) -> dict[int, dict[str, int]]:
    """bin -> {signature string -> #super-k-mers} over the whole dataset."""
    agg: dict[int, dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for codes, _, _ in batching.batch_file(
        cfg.dataset, cfg.sequence_type, cfg.k, cfg.reads_per_batch, cfg.read_len
    ):
        sc = _sig_histogram_batch(jnp.asarray(codes), cfg.k, cfg.m, cfg.b, smax)
        idx = np.flatnonzero(np.asarray(sc.is_uniq))
        sigs = np.asarray(sc.words)[idx, 0]
        cnts = np.asarray(sc.counts)[idx]
        bins = np.asarray(sc.bins)[idx]
        for s, c, b in zip(sigs.tolist(), cnts.tolist(), bins.tolist()):
            agg[b][s] += c

    out: dict[int, dict[str, int]] = {}
    sentinel = 1 << (2 * cfg.m)
    for b, hist in agg.items():
        out[b] = {
            ("<none>" if s == sentinel else _sig_str(s, cfg.m)): c for s, c in hist.items()
        }
    return out


def _sig_str(sig: int, m: int) -> str:
    return bits.decode_codes(
        np.array([(sig >> (2 * (m - 1 - i))) & 3 for i in range(m)], dtype=np.uint8)
    )


def save_bin_signatures(cfg: JobConfig, smax: int = 64) -> str:
    """Write per-bin signature histograms in the reference's file format
    (saveBinSignatures, SparkBinKmerCounter.scala:920-953)."""
    hists = find_bin_signatures(cfg, smax)
    out_dir = cfg.output_dir
    os.makedirs(out_dir, exist_ok=True)
    for b, hist in hists.items():
        with open(os.path.join(out_dir, f"bin_signatures{b}.txt"), "w") as f:
            tot = 0
            for s, c in sorted(hist.items()):
                f.write(f"{s}\t{c}\n")
                tot += c
            f.write(f"Total\t{tot}\n")
    return out_dir


def evaluate_partition_balance(cfg: JobConfig, owner_map: np.ndarray, out_path: str) -> dict:
    """Dump per-partition loads (evaluatePartitionBalance equivalent,
    without the reference's hardcoded hdfs://mycluster URI)."""
    from .ops import count_sort as cs
    from .ops import extract as ex_mod

    B = cfg.b
    hist = np.zeros(B, dtype=np.int64)

    @_partial(jax.jit, static_argnames=())
    def est(codes):
        e = ex_mod.extract(codes, cfg.k, cfg.m, B)
        return cs.bin_histogram(e.bins, e.valid, B)

    for codes, _, _ in batching.batch_file(
        cfg.dataset, cfg.sequence_type, cfg.k, cfg.reads_per_batch, cfg.read_len
    ):
        hist += np.asarray(est(jnp.asarray(codes)), dtype=np.int64)

    n_parts = int(owner_map.max()) + 1 if owner_map.size else 1
    per_part: dict[int, list] = defaultdict(list)
    for b in range(B):
        if hist[b]:
            per_part[int(owner_map[b])].append((b, int(hist[b])))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for p in sorted(per_part):
            total = sum(s for _, s in per_part[p])
            f.write(f"partition {p}\ttotal {total}\n")
            for b, s in per_part[p]:
                f.write(f"  bin {b}\t{s}\n")
    from .parallel import partitioner

    return partitioner.balance_stats(hist, owner_map, n_parts)
