"""Headline benchmark: PRODUCTION streaming k-mer counting on one GPU —
the exact path ``execute_job`` runs on the device (stage-1 extract per
batch, NO per-batch sort, deferred fan-in merges in the DeviceAccumulator),
with a pipelined feed and ONE fence at the end.  Canonical workload shape
k=28 m=10 (the reference's benchmark config, README.md:86-90).

Workload: reads sampled from a fixed synthetic genome at ~16x coverage —
the sequencing-shaped case the accumulator exists for (distinct k-mers
bounded by genome size, heavy cross-batch duplication).  Unlike round 1's
per-batch-step number, this measures END-TO-END exact counting: every
cross-batch merge and the final dedup are inside the timed region; the
fence is a scalar stats pull that depends on the last merge.

Host<->device staging is excluded (pre-staged device arrays).

Prints ONE JSON line: {"metric", "value", "unit", "device"}, where
``device`` names the platform, device kind, device count and the card's
``name, power.limit`` as nvidia-smi reports them.  Exits non-zero when JAX
finds no GPU.
Extra modes (argv[1]): "step" re-measures the round-1 per-batch sort-count
step; "percount" streams with per-batch counting (acc.add) instead of the
deferred raw feed (acc.add_raw) — the A/B for the deferred-sort claim.
Diagnostics go to stderr; stdout stays a single JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

K, M, B = 28, 10, 512
R, L = 4096, 4096  # 16.8 Mbp per batch
GENOME = 1 << 24  # 16.8 Mbp genome -> distinct k-mers bounded by GENOME
NBATCH = 16  # 268 Mbp total, ~16x coverage
import os as _os

FANIN = int(_os.environ.get("FASTKMER_BENCH_FANIN", "16"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_record() -> dict:
    """The device every number was taken on; raises SystemExit without a
    GPU (a CPU run must never be reported as a device measurement)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {devs[0].platform!r}")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi unavailable ({e})"
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def make_batches(rng: np.random.Generator):
    """Reads are random substrings of one fixed genome (coverage sampling)."""
    genome = rng.integers(0, 4, size=GENOME + L, dtype=np.int64).astype(np.uint8)
    out = []
    for _ in range(NBATCH):
        starts = rng.integers(0, GENOME, size=R)
        out.append(genome[starts[:, None] + np.arange(L)[None, :]])
    return out


def run_stream(staged, mode: str) -> tuple[float, dict]:
    import jax.numpy as jnp  # noqa: F401

    from fastkmer_tpu import pipeline

    def feed(acc):
        import jax.numpy as jnp

        pre_over = jnp.zeros((), jnp.int32)
        npos = R * (L - K + 1)
        dcap = (npos + (-npos % (1 << 16))) // 4
        for i, codes in enumerate(staged):
            if mode == "stream" and i % 16 == 0:
                # production probe cost on a distinct-heavy stream: the
                # adaptive controller's probe IS a dedup attempt, every
                # 16th batch (decision lands at DEDUP_LAG); at this
                # workload's ratio (~0.63 > dcap/npos) it overflows and
                # the batch is re-fed its retained raw columns — both
                # dispatches are in the timed region, exactly like
                # count_batches
                _dc, _dw, _nu, over, raw_cols = pipeline._batch_count_dedup(
                    codes, K, M, B, dcap
                )
                pre_over = pre_over + (over > 0)  # fenced via stats below
                acc.add_raw(raw_cols)  # overflow fallback: no re-extraction
            elif mode == "percount":
                acc.add(pipeline._batch_count(codes, K, M, B))
            elif mode == "dedup":
                npos = R * (L - K + 1)
                dcap = (npos + (-npos % (1 << 16))) // 4
                dcols, dwts, _nu, over, _raw = pipeline._batch_count_dedup(
                    codes, K, M, B, dcap
                )
                pre_over = pre_over + over  # lazy device add, no sync
                acc.add_part(dcols, dwts)
            else:
                acc.add_raw(pipeline._batch_extract_keys(codes, K, M, B))
        acc._merge_pending()
        stats = acc._stats()  # scalar pull: fences every dispatch above
        if mode == "dedup":
            assert int(np.asarray(pre_over)) == 0
        return stats

    def fresh():
        return pipeline.DeviceAccumulator(K, fanin=FANIN, m=M, B=B, unique_ub=GENOME)

    t = time.perf_counter()
    stats = feed(fresh())  # warmup: compiles extract + both merge shapes
    log(f"warmup {time.perf_counter() - t:.1f}s stats={stats}")
    t0 = time.perf_counter()
    acc = fresh()
    stats = feed(acc)
    dt = time.perf_counter() - t0
    assert stats["overflow"] == 0, stats
    # sanity: distinct canonical k-mers ~ GENOME * (1 - exp(-coverage))
    assert 0.5 * GENOME < stats["n_unique"] <= GENOME + L, stats
    return dt, stats


def run_step(staged) -> float:
    """The per-batch sort-count step alone (no cross-batch merge)."""
    from fastkmer_tpu import pipeline

    codes = staged[0]

    def step(c):
        return pipeline._batch_count(c, K, M, B)

    def sync(sc):
        return np.asarray(sc.n_valid), np.asarray(sc.counts[:8])

    for _ in range(2):
        sync(step(codes))
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(codes)
    sync(out)
    return R * L * iters / (time.perf_counter() - t0) / 1e9


def run_controller(staged, prededup) -> tuple[float, dict]:
    """The PRODUCTION single-chip controller (pipeline.count_batches):
    warm-up + cadence probes, engage/disengage, in-flight dedup admission.
    ``prededup`` None = adaptive, True = forced dedup, False = forced raw —
    all three measured through the IDENTICAL harness (same final table
    pull), so adaptive-vs-forced ratios are apples to apples (the warm-up
    schedule's acceptance gate, VERDICT r4 #2)."""
    from fastkmer_tpu import pipeline

    def feed():
        return pipeline.count_batches(
            ((c, 0, 0) for c in staged), K, M, B, unique_ub=GENOME,
            prededup=prededup, device_accumulate=True,
        )

    t = time.perf_counter()
    res = feed()  # warmup: compiles extract, probe count, dedup, merges
    log(f"warmup {time.perf_counter() - t:.1f}s uniques={res.words.shape[0]}")
    t0 = time.perf_counter()
    res = feed()
    dt = time.perf_counter() - t0
    return dt, {"n_unique": int(res.words.shape[0]), "overflow": 0}


def main() -> None:
    global GENOME
    mode = sys.argv[1] if len(sys.argv) > 1 else "stream"
    if len(sys.argv) > 2 and sys.argv[2] == "dup":
        # duplication-heavy workload: 2 Mbp genome -> ~8x IN-BATCH coverage
        # (the regime where per-batch pre-dedup pays; VERDICT #9)
        GENOME = 1 << 21
    GENOME = int(_os.environ.get("FASTKMER_BENCH_GENOME", GENOME))
    import jax

    from fastkmer_tpu import pipeline  # noqa: F401  (enables the XLA cache)

    device = device_record()

    rng = np.random.default_rng(0)
    log("generating + staging batches ...")
    staged = [jax.device_put(b) for b in make_batches(rng)]
    np.asarray(staged[-1][0, :4])  # land all H2D before timing

    extra = None
    if mode == "step":
        gbps = run_step(staged)
        metric = "count_step_throughput_k28_m10"
    else:
        if mode in ("adaptive", "forced", "raw"):
            dt, stats = run_controller(
                staged, {"adaptive": None, "forced": True, "raw": False}[mode]
            )
        else:
            dt, stats = run_stream(staged, mode)
        bases = NBATCH * R * L
        gbps = bases / dt / 1e9
        log(f"{mode}: {bases/1e6:.0f} Mbp in {dt:.2f}s, uniques={stats['n_unique']}")
        metric = (
            "stream_count_throughput_k28_m10"
            if mode == "stream"
            else f"stream_{mode}_throughput_k28_m10"
        )
        if GENOME != 1 << 24:
            metric += "_dup"
        elif mode == "stream":
            # the default run reports the per-batch step beside the
            # end-to-end number
            extra = {
                "step_gbps": run_step(staged),
                "note": (
                    "value = END-TO-END streaming incl. all cross-batch "
                    "merges + final dedup; step_gbps = per-batch "
                    "sort-count step only"
                ),
            }
    rec = {
        "metric": metric,
        "value": gbps,
        "unit": "Gbp/s",
        "device": device,
    }
    if extra:
        rec["extra"] = extra
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
