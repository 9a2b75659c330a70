"""Device selection, removed kernels, compile cache, device-memory
budget, and the on-card smoke test's CPU-testable parts."""

import os
import subprocess
import sys

import numpy as np
import pytest

import humid_tpu._backend as B
from humid_tpu import words as W
from humid_tpu.ops import find_neighbor_pairs, unique_words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_profile():
    B._reset_profile_for_tests()
    yield
    B._reset_profile_for_tests()


def _uniq(n=600, seed=0):
    codes = np.random.default_rng(seed).integers(0, 4, (n, 24)).astype(
        np.uint8)
    return unique_words(W.pack_words(codes))[0]


def test_gpu_backend_is_colocated(monkeypatch):
    import jax

    monkeypatch.delenv("HUMID_TPU_DEVICE_ENGINE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    prof = B.backend_profile(refresh=True)
    assert prof == {"backend": "gpu", "colocated_device": True,
                    "forced": None}


@pytest.mark.parametrize("force,expect", [("host", False), ("0", False),
                                          ("device", True), ("1", True)])
def test_env_force_beats_gpu_backend(monkeypatch, force, expect):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("HUMID_TPU_DEVICE_ENGINE", force)
    prof = B.backend_profile(refresh=True)
    assert prof["colocated_device"] is expect
    assert prof["forced"] is expect


def test_gpu_host_wins_routes_host_engines(monkeypatch):
    """Co-location only makes the device engines eligible: a
    calibration where the host wins keeps every phase on the host."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setitem(B.__dict__, "_CALIB", {
        "unique_host_ns": 10.0, "unique_device_ns": 100.0,
        "neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 1000.0,
        "neighbors_runs_device_ns": 2000.0,
        "cc_host_ns": 10.0, "cc_device_ns": 100.0})
    assert B.pick_neighbor_engine() == "runs"
    assert B.use_device_engine("unique") is False
    assert B.use_device_engine("cc") is False


def test_describe_device_names_backend_and_kind():
    assert B.describe_device() == "cpu cpu x8"


@pytest.mark.parametrize("strategy", ["runs", "runs_device", "sharded"])
def test_pallas_impl_rejected_every_strategy(strategy):
    with pytest.raises(ValueError, match="impl"):
        find_neighbor_pairs(_uniq(), 1, word_length=24, impl="pallas",
                            strategy=strategy)


def test_pallas_impl_env_rejected(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_IMPL", "pallas")
    with pytest.raises(ValueError, match="impl"):
        find_neighbor_pairs(_uniq(), 1, word_length=24)


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="strategy"):
        find_neighbor_pairs(_uniq(), 1, word_length=24,
                            strategy="pallas_ring")


def test_no_calibration_row_for_removed_kernels():
    assert set(B._NEIGHBOR_ENGINES) == {
        "runs", "bucketed", "runs_device", "sharded_bucketed"}


@pytest.fixture
def _restore_cache_dir():
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   _restore_cache_dir):
    import jax

    from humid_tpu._util import configure_compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code configures nothing else.
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_fixed_dir_in_checkout(monkeypatch,
                                             _restore_cache_dir):
    import jax

    from humid_tpu._util import COMPILE_CACHE_DIR, configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert COMPILE_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert configure_compile_cache() == COMPILE_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == COMPILE_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_fused_not_eligible_without_bytes_limit():
    from humid_tpu.ops import fused as F

    assert F.device_bytes_limit() is None  # the CPU backend reports none
    assert F.fused_fits(1024, 2) is False


def test_fused_fits_uses_reported_limit(monkeypatch):
    import jax

    from humid_tpu.ops import fused as F

    class _Card:
        def memory_stats(self):
            return {"bytes_limit": 1 << 30}

    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: [_Card()])
    assert F.device_bytes_limit() == 1 << 30
    assert F.fused_fits(1 << 20, 2) is True        # ~100 MB needed
    assert F.fused_fits(1 << 24, 2) is False       # ~1.6 GB needed


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_data_deterministic_and_shaped(tmp_path):
    f1, w1 = chip_smoke.write_dataset(str(tmp_path / "a"), 3000, seed=5,
                                      want_words=True)
    f2, w2 = chip_smoke.write_dataset(str(tmp_path / "b"), 3000, seed=5,
                                      want_words=True)
    f3, _ = chip_smoke.write_dataset(str(tmp_path / "c"), 3000, seed=6)
    for a, b in zip(f1, f2):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert open(f1[0], "rb").read() != open(f3[0], "rb").read()
    np.testing.assert_array_equal(w1, w2)
    for mate, path in enumerate(f1, 1):
        lines = open(path, "rb").read().split(b"\n")[:-1]
        assert len(lines) == 4 * 3000
        name, seq, plus, qual = lines[:4]
        assert len(seq) == len(qual) == 150 and plus == b"+"
        assert set(seq) <= set(b"ACGT")
        head, tail = name.split(b" ")
        assert tail == f"{mate}:N:0:ATCACGAT".encode()
        assert W.extract_umi(name.decode()) == head.split(b":")[-1].decode()
        assert len(head.split(b":")[-1]) == 8
    assert w1.shape == (3000, 24)


def test_smoke_words_are_the_cli_words(tmp_path):
    """The generator's words (UMI + 8 nt of each mate) build the same
    unique table the CLI builds from the FastQ files."""
    from humid_tpu.pipeline import run

    files, words = chip_smoke.write_dataset(str(tmp_path / "d"), 4000,
                                            seed=3, want_words=True)
    res = run(files, dir_name=str(tmp_path / "o"), log_name=os.devnull,
              write_dedup=False)
    assert res.unique == len(chip_smoke.unique_table(words))
    # Skewed families: duplicates dominate, yet many words are unique.
    assert 0.2 * 4000 < res.unique < 0.9 * 4000


def test_smoke_comparator_reports_differences(tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    ref.mkdir()
    ours.mkdir()
    for d in (ref, ours):
        (d / "stats.dat").write_bytes(b"total: 10\n")
        (d / "x_dedup.fastq").write_bytes(b"@a\nACGT\n+\nIIII\n")
    assert chip_smoke.compare_outputs(str(ref), str(ours)) == []
    (ours / "x_dedup.fastq").write_bytes(b"@a\nACGA\n+\nIIII\n")
    (ref / "counts.dat").write_bytes(b"1\t1\n")
    (ours / "extra.dat").write_bytes(b"")
    assert chip_smoke.compare_outputs(str(ref), str(ours)) == [
        "only in reference: counts.dat", "only in ours: extra.dat",
        "differs: x_dedup.fastq"]


def test_smoke_spies_record_platform_and_restore():
    from humid_tpu.ops import neighbors as N

    orig = N._all_pairs
    with chip_smoke.device_spies() as seen:
        assert N._all_pairs is not orig
        find_neighbor_pairs(_uniq(), 1, word_length=24, strategy="dense")
    assert N._all_pairs is orig
    assert seen == {"tile_scan": {"cpu"}}
    with pytest.raises(chip_smoke.SmokeFailure, match="cpu"):
        chip_smoke.require_on_gpu(seen, ["tile_scan"], "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="never ran"):
        chip_smoke.require_on_gpu(seen, ["unique"], "t")


def test_bench_refuses_non_gpu_backend(monkeypatch, capsys):
    import bench

    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setattr(sys, "argv", ["bench.py", "--reads", "1000"])
    assert bench.main() == 2
    assert "not a GPU" in capsys.readouterr().err
