"""Platform choice, mesh device lists, the compile cache's place, native
rebuilds, and chip_smoke.py's host-side helpers — all on the CPU.  The one
GPU check carries the ``gpu`` marker: it skips here, and chip_smoke.py runs
it on the card."""

import os

import numpy as np
import pytest

from fastkmer_tpu.core import bits

from . import oracles
from .test_extract import random_reads, to_batch
from .test_pipeline_e2e import write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_args(tmp_path, *extra):
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, ["ACGT" * 20])
    return ["28", "10", "3", "64", "0", "0", fa, str(tmp_path) + "/", "p_",
            "0", "0", "0", *extra]


def test_cli_refuses_gpu_platform_without_gpu(tmp_path):
    from fastkmer_tpu import cli

    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(_cli_args(tmp_path, "--platform", "gpu"))


def test_cli_mesh_larger_than_devices_raises(tmp_path):
    from fastkmer_tpu import cli

    with pytest.raises(RuntimeError, match="mesh of 16 devices"):
        cli.main(_cli_args(tmp_path, "--platform", "cpu", "--mesh", "16"))


def test_api_mesh_larger_than_devices_raises(tmp_path):
    from fastkmer_tpu import api

    fa = str(tmp_path / "in.fa")
    write_fasta(fa, ["ACGT" * 20])
    with pytest.raises(RuntimeError, match="mesh of 16 devices"):
        api.count_kmers_distributed(fa, n_devices=16, bins=64)


def test_gpu_process_mesh_has_no_cpu_fallback(monkeypatch):
    """A GPU process with one card asked for a 4-device mesh raises; it
    must not borrow virtual CPU devices."""
    import jax

    import __graft_entry__
    from fastkmer_tpu.utils import devices

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(devices, "on_cpu_by_choice", lambda: False)
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    with pytest.raises(RuntimeError, match="needs 4 gpu devices; this process has 1"):
        __graft_entry__.dryrun_multichip(4)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    import jax

    from fastkmer_tpu.utils import jaxcache

    want = str(tmp_path / "env_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    jaxcache.enable()
    assert jaxcache.cache_dir() == want
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, tmp_path):
    import jax

    from fastkmer_tpu.utils import jaxcache

    assert jaxcache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == jaxcache.DEFAULT_DIR
    # point the default somewhere harmless, so the test writes no cache
    # into the checkout
    monkeypatch.setattr(jaxcache, "DEFAULT_DIR", str(tmp_path / "default"))
    before = jax.config.jax_compilation_cache_dir
    try:
        jaxcache.enable()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "default")
        assert os.path.isdir(tmp_path / "default")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_rebuilds_on_foreign_cpu_fingerprint(monkeypatch, tmp_path):
    from fastkmer_tpu.utils import nativebuild

    src, so = tmp_path / "x.cpp", tmp_path / "libx.so"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    so.write_bytes(b"built elsewhere")
    tag = str(so) + ".srchash"
    with open(tag, "w") as f:  # same source, another machine's CPU
        f.write(nativebuild.build_key(str(src)).split(":")[0] + ":0123456789abcdef")
    calls = []

    def fake_compile(cmd, **kw):
        calls.append(cmd)
        so.write_bytes(b"built here")

    monkeypatch.setattr(nativebuild.subprocess, "run", fake_compile)
    assert nativebuild.ensure_built(str(src), str(so))
    assert len(calls) == 1 and "-march=native" in calls[0]
    assert so.read_bytes() == b"built here"
    assert open(tag).read() == nativebuild.build_key(str(src))
    assert nativebuild.ensure_built(str(src), str(so))
    assert len(calls) == 1  # matching key: no rebuild


@pytest.mark.parametrize("k", [13, 28, 31, 32])
def test_smoke_oracle_matches_dict_oracle(k):
    import chip_smoke

    rng = np.random.default_rng(100 + k)
    reads = random_reads(rng, 24, 90) * 2
    words, counts = chip_smoke.oracle_count(to_batch(reads, 90), k)
    got = {km.decode(): c for km, c in
           zip(bits.decode_words_batch(words, k), counts.tolist())}
    assert got == dict(oracles.count_reads(reads, k))
    assert list(map(tuple, words)) == sorted(map(tuple, words))


def test_smoke_fasta_is_deterministic_from_seed(tmp_path):
    import chip_smoke

    from fastkmer_tpu.ingest import fasta

    a = chip_smoke.reads_input(7, 1 << 12, 4.0)
    b = chip_smoke.reads_input(7, 1 << 12, 4.0)
    c = chip_smoke.reads_input(8, 1 << 12, 4.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    pa, pb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    chip_smoke.write_fasta(pa, a)
    chip_smoke.write_fasta(pb, b)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    recs = list(fasta.iter_records(pa))
    assert len(recs) == a.shape[0]
    assert recs[0][1] == chip_smoke.ASCII[a[0]].tobytes()


def test_smoke_refuses_cpu_device():
    import jax

    import chip_smoke

    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.check_devices(jax.devices(), 1)


@pytest.mark.gpu
def test_gpu_platform_accepted_on_gpu(gpu_device):
    """The counterpart of the CPU refusals: on a GPU process ``--platform
    gpu`` is accepted and a one-device mesh is the card itself."""
    from fastkmer_tpu.utils import devices

    devices.select_platform("gpu")
    assert not devices.on_cpu_by_choice()
    assert devices.mesh_devices(1) == [gpu_device]
