"""Multi-host initialization.

The reference scales by adding Spark executors (spark-submit
--num-executors, README.md:86-90); the equivalent here is a multi-host GPU
cluster where every host runs the same program and jax stitches the global
device mesh.  All the counting code in this package is written against a
1-D "data" mesh axis and works unchanged on a multi-host mesh: XLA hands
the all-to-all to NCCL, over NVLink within a host and the network across
hosts.

Tests exercise it with several CPU processes on one machine; on a cluster
it is the intended entry point:

    from fastkmer_tpu.parallel import multihost
    multihost.init_distributed("host0:1234", num_processes=2, process_id=i)
    mesh = multihost.init_global_mesh()          # all GPUs, all hosts
    ctr = stream.DistributedCounter(mesh, ...)   # unchanged

Host-side ingest sharding: each host reads a distinct stripe of the input
(``host_stripe``), mirroring HDFS split locality.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from . import exchange


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """jax.distributed.initialize for a GPU cluster.  Nothing on a plain
    GPU host tells JAX about the cluster, so every process passes the same
    ``coordinator_address`` (``host:port`` of process 0), the total
    ``num_processes`` and its own ``process_id``.  Called without them
    (tests, one host) it is a no-op unless a cluster environment JAX knows
    (e.g. SLURM) supplies them."""
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        pass  # single-process run (tests / one host)


def init_global_mesh(axis: str = exchange.AXIS) -> Mesh:
    """1-D mesh over every chip of every host."""
    return jax.make_mesh((len(jax.devices()),), (axis,), devices=jax.devices())


def agree_min(value: int) -> int:
    """Fleet-wide min of a per-process host scalar (a tiny all_gather over
    the global devices).  Used to re-align checkpoint cursors on resume:
    a crash can land between processes' cursor writes, and resuming from
    disagreeing cursors would desynchronize the collective feed."""
    if jax.process_count() == 1:
        return value
    import numpy as np
    from jax.experimental import multihost_utils

    vals = multihost_utils.process_allgather(np.int64(value))
    return int(np.min(vals))


def barrier(name: str = "fastkmer") -> None:
    """Cross-process sync point (no-op single-process)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def host_stripe(n_items: int) -> tuple[int, int]:
    """[start, end) stripe of a globally-indexed input owned by this host —
    the ingest-sharding analogue of HDFS split assignment."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n_items // p)
    return min(i * per, n_items), min((i + 1) * per, n_items)


def stripe_batches(batches, n_hosts: int | None = None, host_id: int | None = None):
    """Round-robin batch assignment across hosts for streamed files whose
    total size is unknown upfront."""
    p = n_hosts if n_hosts is not None else jax.process_count()
    i = host_id if host_id is not None else jax.process_index()
    for j, b in enumerate(batches):
        if j % p == i:
            yield b


def stripe_batches_padded(batches, rows: int, length: int,
                          n_hosts: int | None = None,
                          host_id: int | None = None):
    """stripe_batches + tail padding so every host feeds the SAME number
    of global steps — the distributed step is a collective, so hosts must
    stay in lockstep.  Hosts whose stripe ran out one batch early feed an
    all-invalid (empty) batch; total steps = ceil(total_batches / p).

    Yields (codes [rows, length], n_reads, n_bases) like the batchers.
    """
    import numpy as np

    from ..core import bits

    p = n_hosts if n_hosts is not None else jax.process_count()
    i = host_id if host_id is not None else jax.process_index()
    total = 0
    mine = 0
    for j, b in enumerate(batches):
        total += 1
        if j % p == i:
            mine += 1
            yield b
    steps = -(-total // p)
    for _ in range(steps - mine):
        yield (
            np.full((rows, length), bits.INVALID_CODE, dtype=np.uint8), 0, 0,
        )
