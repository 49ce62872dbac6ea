#!/usr/bin/env python3
"""Smoke test of the counting path on the GPU, end to end.

Runs the system through the entry points a user calls (``fastkmer_tpu.cli``,
``multiseq.pipeline.execute_multiseq_job``) at real sizes and holds every
result to an independent numpy oracle built here from the same seeded
input: canonical k-mers packed into words, ``np.unique`` with counts,
split at non-ACGT.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: the mesh phase only

Phases (one card):
  gpu-tests  the repo's ``gpu``-marked tests, run here in this process
  kernels  compile the batch step and the accumulator merge at production
           widths (k=28 m=10 B=2048, batch 512x4096, 16-part window), print
           their memory analysis, compare ``ops.extract`` on the card bit
           for bit with the host ``core.bits`` path, time the stage-1 key
           extraction against a large device copy
  A        16.8 Mbp genome, 150-bp reads at 16x (~268 Mbp) through the CLI
           (k=28 m=10 x=3 B=2048 write=1); table.npz == oracle, manifest
           verifies, every bin == the host bin hash; then a profiler trace
           of one merge window of the same path
  B        262 kbp genome at 128x (~33.5 Mbp): adaptive pre-dedup engages;
           exact against the oracle
  C        B's input at k=32 (flagged lane), k=28 useHT=1, k=55 (W=4)
  D        8 sequences of 1 Mbp through multiseq: per-(k-mer, sequence)
           counts and SquaredEuclidean distances against the oracle, and
           the device Gram path against the host f64 path (rtol 1e-4) on
           that table and on one with counts of 12-15 significant bits,
           which a TF32 matmul would round past the bound

Exits non-zero without the result line when JAX finds no GPU or any phase
fails.  Details land in ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

K, M, BINS = 28, 10, 2048
READ_LEN = 150
TIMING_ROWS = (512, 4096)  # batch rows timed by the kernels phase
COPY_WORDS = 1 << 28  # uint32 words in the reference device copy (1 GiB)
ASCII = np.frombuffer(b"ACGTN", np.uint8)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- input --


def make_genome(rng: np.random.Generator, length: int, n_rate: float = 1e-3) -> np.ndarray:
    """Uniform random bases as codes 0..3, with a sprinkle of N (code 4)."""
    g = rng.integers(0, 4, size=length, dtype=np.uint8)
    g[rng.random(length) < n_rate] = 4
    return g


def sample_reads(rng: np.random.Generator, genome: np.ndarray, coverage: float,
                 read_len: int = READ_LEN) -> np.ndarray:
    """[n, read_len] reads sampled uniformly from ``genome`` at ``coverage``."""
    n = int(round(coverage * genome.size / read_len))
    starts = rng.integers(0, genome.size - read_len + 1, size=n)
    return genome[starts[:, None] + np.arange(read_len)]


def write_fasta(path: str, reads: np.ndarray, prefix: str = "r") -> int:
    """One FASTA record per row (fixed-width headers); returns bytes written."""
    n = reads.shape[0]
    width = len(str(max(n - 1, 0)))
    hdr = "".join(f">{prefix}{i:0{width}d}\n" for i in range(n)).encode()
    hdr = np.frombuffer(hdr, np.uint8).reshape(n, -1)
    nl = np.full((n, 1), ord("\n"), np.uint8)
    rec = np.concatenate([hdr, ASCII[reads], nl], axis=1)
    rec.tofile(path)
    return rec.size


def reads_input(seed: int, genome_len: int, coverage: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return sample_reads(rng, make_genome(rng, genome_len), coverage)


# --------------------------------------------------------------- oracle --


def _words_of_windows(codes: np.ndarray, k: int):
    """Canonical packed words [W, R, P] (uint32, big-endian bases, last word
    low-padded) and validity [R, P] of every k-window of ``codes`` [R, L]."""
    R, L = codes.shape
    P = L - k + 1
    W = -(-k // 16)
    bad = np.concatenate(
        [np.zeros((R, 1), np.int32), np.cumsum(codes >= 4, axis=1, dtype=np.int32)],
        axis=1,
    )
    valid = (bad[:, k:] - bad[:, :P]) == 0
    b = (codes & 3).astype(np.uint32)
    fwd = np.zeros((W, R, P), np.uint32)
    rc = np.zeros((W, R, P), np.uint32)
    for w in range(W):
        for pos in range(16 * w, min(16 * w + 16, k)):
            fwd[w] = (fwd[w] << np.uint32(2)) | b[:, pos:pos + P]
            j = k - 1 - pos  # the RC's base at pos is the complement of base j
            rc[w] = (rc[w] << np.uint32(2)) | (np.uint32(3) - b[:, j:j + P])
    pad = 16 * W - k
    if pad:
        fwd[W - 1] <<= np.uint32(2 * pad)
        rc[W - 1] <<= np.uint32(2 * pad)
    use_rc = np.zeros((R, P), bool)
    decided = np.zeros((R, P), bool)
    for w in range(W):
        lt, gt = rc[w] < fwd[w], rc[w] > fwd[w]
        use_rc |= ~decided & lt
        decided |= lt | gt
    return np.where(use_rc[None], rc, fwd), valid


def _unique_counts(words: np.ndarray):
    """words [W, n] -> (unique rows [U, W] ascending, counts int64)."""
    W, n = words.shape
    if n == 0:
        return np.zeros((0, W), np.uint32), np.zeros(0, np.int64)
    if W <= 2:
        key = words[0].astype(np.uint64) << np.uint64(32)
        if W == 2:
            key |= words[1]
        u, c = np.unique(key, return_counts=True)
        out = np.stack([(u >> np.uint64(32)).astype(np.uint32),
                        (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)
        return out[:, :W], c.astype(np.int64)
    order = np.lexsort(words[::-1])
    s = words[:, order]
    new = np.ones(n, bool)
    new[1:] = np.any(s[:, 1:] != s[:, :-1], axis=0)
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, n))
    return np.ascontiguousarray(s[:, starts].T), counts.astype(np.int64)


def oracle_count(codes: np.ndarray, k: int, chunk_positions: int = 1 << 24):
    """Exact canonical k-mer counts over the rows of ``codes`` [R, L] (codes
    >= 4 split windows) by numpy alone -> (words [U, W] ascending, counts)."""
    R, L = codes.shape
    P = L - k + 1
    rows = max(1, chunk_positions // max(P, 1))
    sel = []
    for r0 in range(0, R, rows):
        words, valid = _words_of_windows(codes[r0:r0 + rows], k)
        sel.append(words[:, valid])
    return _unique_counts(np.concatenate(sel, axis=1))


def host_bins(words: np.ndarray, k: int, m: int, B: int) -> np.ndarray:
    """Bin of each k-mer row via the host ``core.bits`` path (norm table,
    window-min signature, reference hash)."""
    from fastkmer_tpu.core import bits

    norm = bits.fill_norm(m)
    pos = np.arange(k)
    widx = pos // 16
    shift = (2 * (15 - pos % 16)).astype(np.uint32)
    nm = k - m + 1
    out = np.empty(words.shape[0], np.int32)
    for s in range(0, words.shape[0], 1 << 20):
        c = (words[s:s + (1 << 20)][:, widx] >> shift) & np.uint32(3)
        mv = np.zeros((c.shape[0], nm), np.uint32)
        for t in range(m):
            mv = (mv << np.uint32(2)) | c[:, t:t + nm]
        out[s:s + c.shape[0]] = bits.hash_to_bucket(norm[mv].min(axis=1), B)
    return out


def host_extract(codes: np.ndarray, k: int, m: int, B: int):
    """Per-position stage-1 output of one batch via numpy + ``core.bits``:
    (words [N, W], valid [N], sigs [N], bins [N])."""
    from numpy.lib.stride_tricks import sliding_window_view

    from fastkmer_tpu.core import bits

    R, L = codes.shape
    words, valid = _words_of_windows(codes, k)
    b = (codes & 3).astype(np.uint32)
    nm = L - m + 1
    mv = np.zeros((R, nm), np.uint32)
    for t in range(m):
        mv = (mv << np.uint32(2)) | b[:, t:t + nm]
    sig = sliding_window_view(bits.fill_norm(m)[mv], k - m + 1, axis=1).min(axis=2)
    W = words.shape[0]
    return (words.reshape(W, -1).T, valid.reshape(-1), sig.reshape(-1),
            bits.hash_to_bucket(sig.reshape(-1), B))


def require(ok, what) -> None:
    """A check that survives ``python -O`` (unlike assert)."""
    if not ok:
        raise AssertionError(what)


def compare_table(label: str, words, counts, expect) -> None:
    ew, ec = expect
    if words.shape != ew.shape or not (
        np.array_equal(words, ew) and np.array_equal(counts, ec)
    ):
        n = min(words.shape[0], ew.shape[0])
        diff = np.flatnonzero(
            np.any(words[:n] != ew[:n], axis=1) | (counts[:n] != ec[:n])
        )
        raise AssertionError(
            f"{label}: table != oracle ({words.shape[0]} vs {ew.shape[0]} "
            f"distinct, {int(counts.sum())} vs {int(ec.sum())} instances, "
            f"first differing row {diff[:1].tolist()})"
        )
    log(f"  {label}: exact ({ew.shape[0]} distinct, {int(ec.sum())} instances)")


# --------------------------------------------------------------- device --


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def check_devices(devs, count: int) -> None:
    """Refuse anything but ``count`` GPUs (no CPU stand-in)."""
    if not devs or devs[0].platform != "gpu":
        found = devs[0].platform if devs else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {found!r}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}")


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def time_call(fn, *args, iters: int = 10) -> float:
    """Median seconds per call, each fenced with block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


@contextlib.contextmanager
def counted(obj, name: str, hit=lambda args, result: True):
    """Count calls of ``obj.name`` for which ``hit(args, result)`` holds."""
    orig = getattr(obj, name)
    box = {"n": 0}

    def wrapper(*args, **kw):
        result = orig(*args, **kw)
        if hit(args, result):
            box["n"] += 1
        return result

    setattr(obj, name, wrapper)
    try:
        yield box
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def run_counters():
    """Host spills, pre-dedup batches and native k-way merges of a run."""
    from fastkmer_tpu import pipeline
    from fastkmer_tpu.output import native as out_native

    with counted(pipeline.DeviceAccumulator, "_spill",
                 lambda a, r: a[1]["n_unique"] > 0) as spills, \
         counted(pipeline, "_batch_count_dedup") as dedup, \
         counted(out_native, "merge_sorted_parts",
                 lambda a, r: r is not None) as merges:
        yield {"spills": spills, "dedup_batches": dedup, "native_merges": merges}


def run_cli(argv: list) -> dict:
    from fastkmer_tpu import cli

    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli exited {rc}")
    i = argv.index("--stats-json")
    with open(argv[i + 1]) as f:
        return json.load(f)


def load_table(out_dir: str):
    z = np.load(os.path.join(out_dir, "table.npz"))
    return z["words"], z["counts"].astype(np.int64), z["bins"]


def load_counts_npz(out_dir: str):
    z = np.load(os.path.join(out_dir, "counts.npz"))
    return z["words"], z["counts"].astype(np.int64)


class Smoke:
    def __init__(self, args):
        import jax

        self.args = args
        self.card = card_info()
        cards = self.card.splitlines() or [""]
        self.label = cards[0] + (f" (x{len(cards)})" if len(cards) > 1 else "")
        self.rng_seed = args.seed
        self.work = tempfile.mkdtemp(prefix="chip_smoke_")
        self.out = os.path.abspath(args.out)
        os.makedirs(self.out, exist_ok=True)
        self.records: list = []
        self.failed: list = []
        self.dev = jax.devices()[0]

    # -- bookkeeping --
    def phase(self, name: str, fn) -> None:
        log(f"\n=== phase {name} ===")
        t = time.perf_counter()
        rec = {"phase": name, "card": self.card}
        try:
            rec.update(fn() or {})
            rec["ok"] = True
        except Exception:
            rec["ok"] = False
            rec["error"] = traceback.format_exc()
            self.failed.append(name)
            log(rec["error"])
        rec["wall_s"] = time.perf_counter() - t
        rec["peak_bytes_in_use"] = peak_bytes()
        self.records.append(rec)
        log(f"phase {name}: {'ok' if rec['ok'] else 'FAILED'} in "
            f"{rec['wall_s']:.3f} s, peak_bytes_in_use={rec['peak_bytes_in_use']}")

    def fasta(self, name: str, reads: np.ndarray) -> str:
        path = os.path.join(self.work, name)
        write_fasta(path, reads)
        return path

    def count_job(self, label: str, fa: str, n_bases: int, k: int = K, m: int = M,
                  use_ht: int = 0, kryo: int = 0, lpt: int = 0, extra=()):
        """One CLI count job -> (summary, out_dir, counters, seconds)."""
        from fastkmer_tpu.ingest import native as in_native

        stats = os.path.join(self.work, f"{label}.json")
        argv = [str(k), str(m), "3", str(BINS), str(use_ht), "0", fa,
                self.work + "/", f"{label}_", "1", str(kryo), str(lpt),
                "--keep-table", "--stats-json", stats, *extra]
        with run_counters() as ctr, \
                open(os.path.join(self.out, f"{label}.log"), "w") as cli_log, \
                contextlib.redirect_stdout(cli_log):
            t = time.perf_counter()
            summary = run_cli(argv)
            dt = time.perf_counter() - t
        out_dir = os.path.join(self.work, f"{label}_k{k}_m{m}_x3_b{BINS}_s0")
        mesh = "--mesh" in extra
        info = {
            "wall_s": dt,
            "gbps": n_bases / dt / 1e9,
            "host_spills": ctr["spills"]["n"],
            # a mesh run dedups in its streaming transport, not per batch
            "dedup_batches": (summary["n_dedup_batches"] if mesh
                              else ctr["dedup_batches"]["n"]),
            "native_merges": ctr["native_merges"]["n"],
            "native_ingest": bool(in_native.available()),
        }
        log(f"  {label}: {n_bases / 1e6:.1f} Mbp in {dt:.3f} s = "
            f"{info['gbps']:.4f} Gbp/s on {self.label} (includes compilation); "
            f"table pulls (host spills + final) {info['host_spills']}, "
            f"{'mesh transport ' if mesh else ''}dedup batches "
            f"{info['dedup_batches']}, native merges {info['native_merges']}, "
            f"native ingest {info['native_ingest']}")
        return summary, out_dir, info

    # -- phases --
    def gpu_tests(self) -> dict:
        """The repo's ``gpu``-marked tests on the card, in this process
        (tests/conftest.py leaves the platform alone under ``-m gpu``)."""
        import pytest

        class Tally:
            passed = 0

            def pytest_runtest_logreport(self, report):
                if report.when == "call" and report.passed:
                    self.passed += 1

        tally = Tally()
        tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests],
                         plugins=[tally])
        require(rc == 0, f"gpu-marked tests exited {rc}")
        require(tally.passed > 0, "no gpu-marked test ran")
        log(f"  {tally.passed} gpu-marked tests passed on {self.label}")
        return {"gpu_tests_passed": tally.passed}

    def kernels(self) -> dict:
        import jax
        import jax.numpy as jnp

        from fastkmer_tpu import pipeline
        from fastkmer_tpu.ops import extract

        R, L = 512, 4096
        P = L - K + 1
        npos = R * P
        rec: dict = {}
        sds = jax.ShapeDtypeStruct
        comp = pipeline._batch_extract_keys.lower(
            sds((R, L), jnp.uint8), k=K, m=M, B=BINS
        ).compile()
        log(f"  batch step memory: {comp.memory_analysis()}")
        acc_cap = 1 << 22  # DeviceAccumulator's first sizing at this batch
        part = (tuple(sds((npos,), jnp.uint32) for _ in range(2)), None)
        acc = (tuple(sds((acc_cap,), jnp.uint32) for _ in range(2)),
               sds((acc_cap,), jnp.int32), sds((), jnp.int32), sds((), jnp.int32))
        t = time.perf_counter()
        mcomp = pipeline._MERGE_JIT.lower((part,) * 16, acc).compile()
        rec["merge16_compile_s"] = time.perf_counter() - t
        log(f"  16-part merge memory: {mcomp.memory_analysis()} "
            f"(compiled in {rec['merge16_compile_s']:.3f} s)")

        # bit-for-bit: device extract vs the host core.bits path
        reads = reads_input(self.rng_seed + 11, 1 << 20, 8.0)
        codes = np.full((R, L), 4, np.uint8)
        flat = reads[: (R * L) // (READ_LEN + 1)]
        rows = np.concatenate([flat, np.full((flat.shape[0], 1), 4, np.uint8)], 1)
        codes.reshape(-1)[: rows.size] = rows.reshape(-1)
        ex = jax.jit(lambda c: extract.extract(c, K, M, BINS))(jnp.asarray(codes))
        hw, hv, hs, hb = host_extract(codes, K, M, BINS)
        dv = np.asarray(ex.valid)
        require(np.array_equal(dv, hv), "validity differs")
        require(np.array_equal(np.asarray(ex.words)[dv], hw[hv]), "words differ")
        require(np.array_equal(np.asarray(ex.sigs)[dv], hs[hv]), "signatures differ")
        require(np.array_equal(np.asarray(ex.bins)[dv], hb[hv]), "bins differ")
        log(f"  extract on the card == host core.bits on {int(hv.sum())} windows")

        # stage-1 key extraction against a large device copy
        x = jnp.zeros(COPY_WORDS, jnp.uint32)
        t_copy = time_call(jax.jit(lambda v: v ^ jnp.uint32(1)), x)
        copy_gbs = 2 * x.nbytes / t_copy / 1e9
        del x
        log(f"  device copy (read+write 1 GiB): {t_copy * 1e3:.3f} ms = "
            f"{copy_gbs:.1f} GB/s on {self.label}")
        rec["copy_gbs"] = copy_gbs
        rng = np.random.default_rng(self.rng_seed)
        for k, m in ((28, 10), (97, 13)):
            for rows_ in TIMING_ROWS:
                c = jnp.asarray(rng.integers(0, 4, size=(rows_, L), dtype=np.uint8))
                fn = lambda v, k=k, m=m: pipeline._batch_extract_keys(v, k, m, BINS)
                t_ex = time_call(fn, c)
                W = -(-k // 16)
                nbytes = rows_ * L + W * rows_ * (L - k + 1) * 4
                gbs = nbytes / t_ex / 1e9
                rec[f"extract_k{k}_{rows_}x{L}"] = {
                    "ms": t_ex * 1e3, "gbs": gbs, "share_of_copy": gbs / copy_gbs,
                }
                log(f"  _batch_extract_keys k={k} [{rows_}, {L}]: "
                    f"{t_ex * 1e3:.3f} ms, {gbs:.1f} GB/s "
                    f"({gbs / copy_gbs:.2f} of the copy) on {self.label}")
        return rec

    def phase_a(self) -> dict:
        reads = reads_input(self.rng_seed, 1 << 24, 16.0)
        fa = self.a_fasta = self.fasta("a.fa", reads)
        n_bases = reads.size
        log(f"  input: {reads.shape[0]} reads x {READ_LEN} bp = {n_bases} bp")
        summary, out_dir, info = self.count_job("A", fa, n_bases)
        from fastkmer_tpu.output import manifest

        status = manifest.verify_output(out_dir)
        require(status["ok"], status)
        words, counts, bins = load_table(out_dir)
        t = time.perf_counter()
        expect = oracle_count(reads, K)
        info["oracle_s"] = time.perf_counter() - t
        compare_table("A table.npz", words, counts, expect)
        hb = host_bins(words, K, M, BINS)
        require(np.array_equal(bins, hb), "bins differ from the host bin hash")
        log(f"  every bin == host bin hash; manifest verifies "
            f"({len(summary['timings'])} timed stages: {summary['timings']})")
        info["timings"] = summary["timings"]
        info["n_unique"] = int(words.shape[0])
        return info

    def phase_a_trace(self) -> dict:
        """Profiler trace of one merge window of phase A's path (the first
        16 batches through count_batches), reduced to device time per
        program and per op."""
        import jax

        from fastkmer_tpu import pipeline
        from fastkmer_tpu.ingest import batch as batching

        batches = list(itertools.islice(
            batching.batch_file(self.a_fasta, 0, K, 512, 4096), 16))
        pipeline.count_batches(iter(batches), K, M, BINS)  # warm every shape
        tdir = os.path.join(self.out, "trace_a")
        shutil.rmtree(tdir, ignore_errors=True)
        with jax.profiler.trace(tdir):
            t = time.perf_counter()
            pipeline.count_batches(iter(batches), K, M, BINS)
            wall = time.perf_counter() - t
        rec = reduce_trace(tdir)
        rec["wall_s"] = wall
        with open(os.path.join(self.out, "trace_a_summary.json"), "w") as f:
            json.dump(rec, f, indent=1)
        busy = max(rec["busy_s"], 1e-12)
        log(f"  traced window: {wall:.3f} s wall, device busy "
            f"{rec['busy_s']:.4f} s (idle share {1 - rec['busy_s'] / wall:.3f}) "
            f"on {self.label}")
        for mod, s in rec["modules"][:8]:
            log(f"    module {mod}: {s:.4f} s ({s / busy:.3f} of busy)")
        for op, s in rec["ops"][:15]:
            log(f"    op {op}: {s:.4f} s")
        return {"trace": {k: rec[k] for k in ("busy_s", "wall_s", "modules")}}

    def b_input(self):
        """Phase B's input (also phase C's): a 262 kbp genome at 128x."""
        if not hasattr(self, "b_fasta"):
            self.b_reads = reads_input(self.rng_seed + 1, 1 << 18, 128.0)
            self.b_fasta = self.fasta("b.fa", self.b_reads)
        return self.b_reads, self.b_fasta

    def phase_b(self) -> dict:
        reads, fa = self.b_input()
        _, out_dir, info = self.count_job("B", fa, reads.size)
        words, counts, _ = load_table(out_dir)
        compare_table("B table.npz", words, counts, oracle_count(reads, K))
        require(info["dedup_batches"] > 1, "pre-dedup never engaged")
        return info

    def phase_c(self) -> dict:
        reads, fa = self.b_input()
        out = {}
        for label, k, use_ht in (("C32", 32, 0), ("Cht", 28, 1), ("C55", 55, 0)):
            _, out_dir, info = self.count_job(label, fa, reads.size, k=k,
                                              use_ht=use_ht, kryo=1)
            words, counts = load_counts_npz(out_dir)
            compare_table(f"{label} counts.npz", words, counts, oracle_count(reads, k))
            out[label] = info
        # the numpy oracle itself against the repo's plain dict oracle at W=4
        from tests import oracles

        sub = reads[:2000]
        strs = ["".join(ASCII[r].tobytes().decode()) for r in sub]
        w, c = oracle_count(sub, 55)
        from fastkmer_tpu.core import bits

        mine = dict(zip((km.decode() for km in bits.decode_words_batch(w, 55)),
                        c.tolist()))
        require(mine == dict(oracles.count_reads(strs, 55)), "numpy oracle != dict oracle")
        log("  numpy oracle == tests/oracles.count_reads at k=55 (2000 reads)")
        return out

    def phase_d(self) -> dict:
        from fastkmer_tpu.multiseq import distances as dist_mod
        from fastkmer_tpu.multiseq.pipeline import (
            MultiseqConfig, accumulate_distances, execute_multiseq_job,
        )

        seqs, fa = self.multiseq_input(8, 1_000_000, "d.fa")
        cfg = MultiseqConfig(
            dataset=fa, output_directory=self.work + "/", k=K, m=M, max_b=BINS,
            sequence_type=1, prefix="D_",
        )
        with run_counters() as ctr:
            t = time.perf_counter()
            res = execute_multiseq_job(cfg, verbose=False, keep_table=True)
            dt = time.perf_counter() - t
        n_bases = sum(s.size for s in seqs)
        log(f"  multiseq: {n_bases / 1e6:.1f} Mbp in {dt:.3f} s = "
            f"{n_bases / dt / 1e9:.4f} Gbp/s on {self.label} (includes "
            f"compilation); table pulls (host spills + final) "
            f"{ctr['spills']['n']}, native merges {ctr['native_merges']['n']}, "
            f"native ingest not used (multiseq ingest parses in Python)")
        self.check_multiseq("D", res, seqs)
        S = len(seqs)
        measure = dist_mod.get_measure("multisequence.SquaredEuclidean")
        want = squared_euclidean(seqs)
        for (a, b), d in res.distances.items():
            ia, ib = res.sequence_names.index(a), res.sequence_names.index(b)
            require(np.isclose(d, want[ia, ib], rtol=1e-9, atol=0), (a, b, d, want[ia, ib]))
        log(f"  {len(res.distances)} SquaredEuclidean distances == direct numpy")
        out = {"wall_s": dt, "gbps": n_bases / dt / 1e9}
        # the device Gram path against the host f64 path, on the run's table
        # (counts of a few bits: exact even in TF32) and on its first 128
        # k-mers shared by all S sequences at seeded copy numbers of
        # 4096..32767 (12-15 significant bits: a TF32 matmul rounds them)
        rng = np.random.default_rng(self.rng_seed + 4)
        G = 128
        wide_words = np.repeat(np.unique(res.words, axis=0)[:G], S, axis=0)
        wide_seqs = np.tile(np.arange(S, dtype=np.int32), G)
        wide_counts = (np.repeat(rng.integers(4096, 16384, size=G), S)
                       + rng.integers(0, 16384, size=G * S))
        for name, table in (("run table", (res.words, res.seqs, res.counts)),
                            ("wide counts", (wide_words, wide_seqs, wide_counts))):
            host = accumulate_distances(*table, S, measure, device=False)
            dev = accumulate_distances(*table, S, measure, device=True)
            off = ~np.eye(S, dtype=bool)
            err = float(np.max(np.abs(dev - host)[off] / np.abs(host)[off]))
            np.testing.assert_allclose(dev, host, rtol=1e-4)
            log(f"  device Gram path == host f64 path on the {name}, "
                f"max relative error {err:.3e}")
            out[f"gram_max_rel_err_{name.replace(' ', '_')}"] = err
        return out

    def multiseq_input(self, S: int, length: int, name: str):
        """S related sequences: one seeded base genome, 2% substitutions each."""
        rng = np.random.default_rng(self.rng_seed + 3)
        base = make_genome(rng, length)
        seqs = []
        for _ in range(S):
            s = base.copy()
            hit = rng.random(length) < 0.02
            s[hit] = (s[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
            seqs.append(s)
        path = os.path.join(self.work, name)
        with open(path, "wb") as f:
            for i, s in enumerate(seqs):
                f.write(f">seq{i}\n".encode() + ASCII[s].tobytes() + b"\n")
        return seqs, path

    def check_multiseq(self, label: str, res, seqs) -> None:
        words, sid, counts = [], [], []
        for i, s in enumerate(seqs):
            w, c = oracle_count(s[None, :], K)
            words.append(w)
            sid.append(np.full(c.size, i, np.int32))
            counts.append(c)
        words, sid, counts = (np.concatenate(x) for x in (words, sid, counts))
        order = np.lexsort((sid, words[:, 1], words[:, 0]))
        require(res.sequence_names == [f"seq{i}" for i in range(len(seqs))],
                f"{label}: sequence names {res.sequence_names}")
        require(np.array_equal(res.words, words[order]), f"{label}: k-mers differ")
        require(np.array_equal(res.seqs, sid[order]), f"{label}: sequence lanes differ")
        require(np.array_equal(res.counts, counts[order]), f"{label}: counts differ")
        log(f"  {label}: per-(k-mer, sequence) counts exact ({order.size} rows)")

    def mesh(self) -> dict:
        """Four cards: phase A's input with --mesh 4 and LPT ownership, then
        the prededup transport, the smer transport and multiseq lanes at a
        small size — each against the oracle."""
        import jax

        from fastkmer_tpu.multiseq.distributed import execute_multiseq_job_distributed
        from fastkmer_tpu.multiseq.pipeline import MultiseqConfig
        from fastkmer_tpu.parallel import exchange
        from fastkmer_tpu.utils import devices

        out = {}
        reads = reads_input(self.rng_seed, 1 << 24, 16.0)
        fa = self.fasta("a.fa", reads)
        _, out_dir, info = self.count_job("M4", fa, reads.size, lpt=1,
                                          extra=("--mesh", "4"))
        words, counts, _ = load_table(out_dir)
        compare_table("mesh A table.npz", words, counts, oracle_count(reads, K))
        out["mesh_a"] = info
        small = reads_input(self.rng_seed + 1, 1 << 18, 16.0)
        sfa = self.fasta("small.fa", small)
        expect = oracle_count(small, K)
        for label, extra in (("Mded", ("--prededup", "on")),
                             ("Msmer", ("--smer-transport",))):
            _, out_dir, info = self.count_job(label, sfa, small.size,
                                              extra=("--mesh", "4", *extra))
            words, counts, _ = load_table(out_dir)
            compare_table(f"mesh {label}", words, counts, expect)
            out[label] = info
        require(out["Mded"]["dedup_batches"] > 0, "dedup transport never ran")
        seqs, mfa = self.multiseq_input(8, 100_000, "m.fa")
        mesh = jax.make_mesh((4,), (exchange.AXIS,), devices=devices.mesh_devices(4))
        cfg = MultiseqConfig(dataset=mfa, output_directory=self.work + "/", k=K,
                             m=M, max_b=BINS, sequence_type=1, prefix="Mms_")
        res = execute_multiseq_job_distributed(cfg, mesh, verbose=False)
        self.check_multiseq("mesh multiseq", res, seqs)
        return out


def squared_euclidean(seqs) -> np.ndarray:
    """D[a, b] = sum over k-mers of (c_a - c_b)^2, from the oracle counts."""
    keys, sid, cnt = [], [], []
    for i, s in enumerate(seqs):
        w, c = oracle_count(s[None, :], K)
        keys.append((w[:, 0].astype(np.uint64) << np.uint64(32)) | w[:, 1])
        sid.append(np.full(c.size, i))
        cnt.append(c)
    u, inv = np.unique(np.concatenate(keys), return_inverse=True)
    C = np.zeros((u.size, len(seqs)))
    C[inv, np.concatenate(sid)] = np.concatenate(cnt)
    S = len(seqs)
    D = np.zeros((S, S))
    for a in range(S):
        for b in range(S):
            D[a, b] = np.sum((C[:, a] - C[:, b]) ** 2)
    return D


def reduce_trace(tdir: str) -> dict:
    """Device time per XLA program and per kernel from a jax.profiler
    trace.  On the GPU every stream of a device plane holds kernel events
    (tagged with their ``hlo_module``) and memcpy events; busy time is the
    union of all their intervals.  Kernel names drop XLA's ``__N`` suffix,
    so the pieces of one sort add up under one name."""
    import re

    import jax

    paths = glob.glob(os.path.join(tdir, "plugins", "profile", "*", "*.xplane.pb"))
    pd = jax.profiler.ProfileData.from_file(paths[0])
    modules: dict = {}
    ops: dict = {}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                mod = str(st.get("hlo_module", ev.name))
                key = f"{mod}:{re.sub(r'__[0-9]+$', '', ev.name)}"
                modules[mod] = modules.get(mod, 0.0) + ev.duration_ns / 1e9
                ops[key] = ops.get(key, 0.0) + ev.duration_ns / 1e9
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {
        "busy_s": busy / 1e9,
        "modules": sorted(modules.items(), key=lambda kv: -kv[1]),
        "ops": sorted(ops.items(), key=lambda kv: -kv[1])[:60],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4 = run only the mesh phase, on four GPUs")
    p.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke"))
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import jax

    from fastkmer_tpu.utils import jaxcache

    check_devices(jax.devices(), args.chips)
    smoke = Smoke(args)
    log(f"card: {smoke.card}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {jaxcache.cache_dir()}")
    log(f"devices: {[d.device_kind for d in jax.devices()]}")
    try:
        if args.chips == 4:
            smoke.phase("mesh4", smoke.mesh)
        else:
            for name, fn in (("gpu-tests", smoke.gpu_tests),
                             ("kernels", smoke.kernels), ("A", smoke.phase_a),
                             ("A-trace", smoke.phase_a_trace), ("B", smoke.phase_b),
                             ("C", smoke.phase_c), ("D", smoke.phase_d)):
                smoke.phase(name, fn)
    finally:
        shutil.rmtree(smoke.work, ignore_errors=True)
        with open(os.path.join(smoke.out, f"summary_{args.chips}.json"), "w") as f:
            json.dump(smoke.records, f, indent=1, default=str)
    if smoke.failed:
        log(f"\nFAILED phases: {smoke.failed}")
        return 1
    devs = jax.devices()
    log(f"\n{smoke.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
