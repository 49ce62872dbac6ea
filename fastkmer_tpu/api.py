"""High-level Python API.

The reference is driven only through spark-submit CLIs; a library user of
fastkmer_tpu gets a direct call surface plus the standard k-mer-counter
derived outputs (spectrum/histogram, singleton stats) that tools like KMC
expose alongside the raw counts.
"""

from __future__ import annotations

import numpy as np

from .config import JobConfig
from .core import bits
from .pipeline import CountResult, execute_job


def count_kmers(
    dataset: str,
    k: int = 28,
    m: int = 10,
    bins: int = 2000,
    sequence_type: int = 0,
    use_ht: bool = False,
    output_directory: str | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    checkpoint_dir: str | None = None,
    **kw,
) -> CountResult:
    """Count canonical k-mers in a FASTA/FASTQ file.  Writes per-bin files
    only when output_directory is given.

    ``unique_ub``: asserted bound on distinct k-mers (e.g. genome length)
    -> sync-free device accumulation, verified at finalize.
    ``prededup``: per-batch pre-dedup for duplication-heavy inputs (None =
    adaptive probing).  ``checkpoint_dir``: kill-and-resume."""
    cfg = JobConfig(
        dataset=dataset,
        output_directory=output_directory or "",
        k=k,
        m=m,
        max_b=bins,
        sequence_type=sequence_type,
        use_ht=use_ht,
        write=output_directory is not None,
        **kw,
    )
    return execute_job(
        cfg, verbose=False, unique_ub=unique_ub, prededup=prededup,
        checkpoint_dir=checkpoint_dir,
    )


def count_kmers_distributed(
    dataset: str,
    n_devices: int | None = None,
    k: int = 28,
    m: int = 10,
    bins: int = 2000,
    sequence_type: int = 0,
    use_ht: bool = False,
    output_directory: str | None = None,
    unique_ub: int | None = None,
    prededup: bool | None = None,
    use_custom_partitioner: bool = False,
    checkpoint_dir: str | None = None,
    **kw,
):
    """Count canonical k-mers over a device mesh (the library form of the
    ``--mesh`` CLI / the reference's spark-submit cluster run).

    ``n_devices``: mesh width (defaults to every visible device; on a
    multi-host fleet call under ``jax.distributed`` with the global device
    count; raises when fewer devices exist).  ``prededup``:
    duplication-aware exchange transport (None = adaptive probing).  ``use_custom_partitioner``: sampled LPT bin->chip
    placement (the reference's MultiprocessorSchedulingPartitioner).
    Returns parallel.driver.DistributedResult (adds owner_map / balance /
    exchange_bytes / n_dedup_batches to the count table)."""
    import jax

    from .parallel import exchange
    from .parallel.driver import execute_job_distributed
    from .utils import devices

    n = n_devices or len(jax.devices())
    mesh = jax.make_mesh((n,), (exchange.AXIS,), devices=devices.mesh_devices(n))
    cfg = JobConfig(
        dataset=dataset,
        output_directory=output_directory or "",
        k=k,
        m=m,
        max_b=bins,
        sequence_type=sequence_type,
        use_ht=use_ht,
        write=output_directory is not None,
        use_custom_partitioner=use_custom_partitioner,
        **kw,
    )
    return execute_job_distributed(
        cfg, mesh, verbose=False, unique_ub=unique_ub, prededup=prededup,
        checkpoint_dir=checkpoint_dir,
    )


def spectrum(res: CountResult, max_count: int = 10000) -> np.ndarray:
    """k-mer spectrum: spectrum[c] = number of distinct k-mers with count c
    (counts above max_count are clamped into the last bucket)."""
    if res.counts.size == 0:
        return np.zeros(max_count + 1, np.int64)
    return np.bincount(
        np.minimum(res.counts, max_count).astype(np.int64), minlength=max_count + 1
    )


def stats(res: CountResult) -> dict:
    """Summary statistics of a count table."""
    c = res.counts
    return {
        "total_kmers": int(c.sum()),
        "distinct_kmers": int(c.size),
        "unique_kmers": int((c == 1).sum()),  # singletons
        "max_count": int(c.max()) if c.size else 0,
        "mean_count": float(c.mean()) if c.size else 0.0,
        "n_reads": res.n_reads,
        "n_bases": res.n_bases,
    }


def to_dict(res: CountResult, k: int) -> dict[str, int]:
    """Count table as {kmer_string: count} (host memory scales with U)."""
    kmers = bits.decode_words_batch(res.words, k)
    return {km.decode(): int(c) for km, c in zip(kmers, res.counts.tolist())}


def dump(res: CountResult, k: int, path: str) -> None:
    """Single-file sorted ``<KMER>\\t<count>`` dump (the KMC-dump analogue,
    vs the per-bin files of the reference format)."""
    with open(path, "wb") as f:
        kmers = bits.decode_words_batch(res.words, k)
        for km, c in zip(kmers, res.counts.tolist()):
            f.write(km + b"\t" + str(int(c)).encode() + b"\n")


def load_binary(path: str) -> CountResult:
    """Load a binary (npz) output written with use_kryo_serializer=1."""
    z = np.load(path)
    counts = z["counts"]
    return CountResult(
        words=z["words"], counts=counts, bins=z["bins"],
        n_instances=int(counts.sum()), n_bases=0, n_reads=0, timings={},
    )
