"""Engine-selection tests: the auto strategy must route the hot phases
to the device engines on a local GPU (when calibration says they win)
and to the host engines on the CPU backend, with env overrides still
winning."""

import numpy as np
import pytest

import humid_tpu._backend as B
from humid_tpu import words as W
from humid_tpu.ops import find_neighbor_pairs, unique_words
from humid_tpu.ops import neighbors as nbmod


@pytest.fixture(autouse=True)
def _fresh_profile(monkeypatch):
    B._reset_profile_for_tests()
    yield
    B._reset_profile_for_tests()


def _rand_packed(n, wl=24, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, wl)).astype(np.uint8)
    packed = W.pack_words(codes)
    uniq, _, _, _ = unique_words(packed)
    return uniq


def test_profile_env_force(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_DEVICE_ENGINE", "device")
    assert B.backend_profile(refresh=True)["colocated_device"] is True
    monkeypatch.setenv("HUMID_TPU_DEVICE_ENGINE", "host")
    assert B.backend_profile(refresh=True)["colocated_device"] is False


def test_profile_cpu_backend_is_host():
    # The test env forces the CPU backend (conftest): never co-located.
    prof = B.backend_profile(refresh=True)
    assert prof["backend"] == "cpu"
    assert prof["colocated_device"] is False
    assert prof["forced"] is None


def test_auto_picks_runs_on_host_backend():
    uniq = _rand_packed(6000)
    assert len(uniq) > 2048
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "runs"


_DEVICE_WINS = {
    "unique_host_ns": 100.0, "unique_device_ns": 10.0,
    "neighbors_runs_ns": 1000.0, "neighbors_bucketed_ns": 100.0,
    "neighbors_runs_device_ns": 2000.0,
    "cc_host_ns": 100.0, "cc_device_ns": 10.0,
}
_HOST_WINS = {
    "unique_host_ns": 10.0, "unique_device_ns": 100.0,
    "neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 1000.0,
    "neighbors_runs_device_ns": 2000.0,
    "cc_host_ns": 10.0, "cc_device_ns": 100.0,
}
_RUNS_DEVICE_WINS = dict(
    _DEVICE_WINS, neighbors_runs_device_ns=50.0)
_MESH_WINS = dict(
    _DEVICE_WINS, neighbors_sharded_ns=20.0,
    neighbors_runs_device_ns=50.0)


def _set_profile(monkeypatch, colocated, calib=None, forced=None):
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu",
         "colocated_device": colocated, "forced": forced})
    monkeypatch.setitem(B.__dict__, "_CALIB", calib)


def test_auto_picks_bucketed_when_calibration_favors_device(monkeypatch):
    """Same pairs, device strategy, when the chip is co-located AND the
    measured constants say the device engine wins."""
    uniq = _rand_packed(6000, seed=1)
    assert len(uniq) > 2048
    ra, rb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    _set_profile(monkeypatch, True, _DEVICE_WINS)
    ba, bb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "bucketed"
    np.testing.assert_array_equal(ra, ba)
    np.testing.assert_array_equal(rb, bb)


def test_auto_picks_runs_device_when_it_measures_fastest(monkeypatch):
    """The device run-sweep engine is a first-class routing target
    (VERDICT r3 #1): same pairs, picked when its constant is the min."""
    uniq = _rand_packed(6000, seed=8)
    ra, rb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    _set_profile(monkeypatch, True, _RUNS_DEVICE_WINS)
    da, db = find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "runs_device"
    np.testing.assert_array_equal(ra, da)
    np.testing.assert_array_equal(rb, db)


def test_auto_picks_mesh_engine_when_it_measures_fastest(monkeypatch):
    """With >1 co-located chip the bucketed mesh search competes as a
    calibrated engine and auto routes to it (VERDICT r3 #6)."""
    uniq = _rand_packed(6000, seed=9)
    ra, rb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    _set_profile(monkeypatch, True, _MESH_WINS)
    ma, mb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "sharded_bucketed"
    np.testing.assert_array_equal(ra, ma)
    np.testing.assert_array_equal(rb, mb)


def test_shardable_only_excludes_mesh_engine(monkeypatch):
    """Host shards broadcast a SHARD-honoring engine: the mesh search
    ignores the host work partition, so it is excluded there."""
    _set_profile(monkeypatch, True, _MESH_WINS)
    assert B.pick_neighbor_engine() == "sharded_bucketed"
    assert B.pick_neighbor_engine(shardable_only=True) == "runs_device"


def test_auto_keeps_runs_when_calibration_favors_host(monkeypatch):
    """Co-located chip alone is NOT evidence: measured constants rule."""
    uniq = _rand_packed(6000, seed=5)
    _set_profile(monkeypatch, True, _HOST_WINS)
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "runs"


def test_auto_sharded_pins_host_engine(monkeypatch):
    """Host shards must all pick the same engine regardless of per-host
    calibration (hashed-runs vs striped-tiles partition the pair set
    differently), so auto pins runs under ``shard``."""
    uniq = _rand_packed(6000, seed=6)
    _set_profile(monkeypatch, True, _DEVICE_WINS)
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto",
                        shard=(0, 2))
    assert nbmod.LAST_DECISION["strategy"] == "runs"


def test_forced_device_engine_skips_calibration(monkeypatch):
    uniq = _rand_packed(6000, seed=7)
    _set_profile(monkeypatch, True, _HOST_WINS, forced=True)
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "bucketed"


def test_engine_constants_disk_cache(monkeypatch, tmp_path):
    """engine_constants round-trips through the per-machine cache file
    without re-measuring."""
    path = tmp_path / "calib.json"
    monkeypatch.setenv("HUMID_TPU_CALIB_PATH", str(path))
    import json

    key = B._calib_key()
    path.write_text(json.dumps({key: dict(_HOST_WINS, ts=0.0)}))
    monkeypatch.setitem(B.__dict__, "_CALIB", None)
    c = B.engine_constants()
    assert c["neighbors_runs_ns"] == 100.0
    # and the comparator reads them
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu",
         "colocated_device": True, "forced": None})
    assert B.use_device_engine("neighbors") is False
    assert B.use_device_engine("unique") is False
    assert B.use_device_engine("cc") is False


def test_calibration_measures_and_persists(monkeypatch, tmp_path):
    """A missing cache entry triggers a real (tiny) measurement whose
    result is written to disk and favors SOME engine for both phases."""
    path = tmp_path / "calib.json"
    monkeypatch.setenv("HUMID_TPU_CALIB_PATH", str(path))
    monkeypatch.setitem(B.__dict__, "_CALIB", None)
    # shrink the probe so the test stays fast
    monkeypatch.setattr(
        B, "_gen_probe_words",
        lambda n, word_length=24, seed=0: _rand_packed(4096, word_length))
    c = B.engine_constants()
    assert c["neighbors_runs_ns"] > 0 and c["neighbors_bucketed_ns"] > 0
    assert c["unique_host_ns"] > 0 and c["unique_device_ns"] > 0
    assert c["cc_host_ns"] > 0 and c["cc_device_ns"] > 0
    import json

    on_disk = json.loads(path.read_text())
    assert B._calib_key() in on_disk


def test_auto_small_input_stays_dense(monkeypatch):
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu", "colocated_device": True})
    uniq = _rand_packed(256, seed=2)
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "dense"


def test_env_strategy_beats_profile(monkeypatch):
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu", "colocated_device": True})
    monkeypatch.setenv("HUMID_TPU_STRATEGY", "runs")
    uniq = _rand_packed(6000, seed=3)
    find_neighbor_pairs(uniq, 1, word_length=24, strategy="auto")
    assert nbmod.LAST_DECISION["strategy"] == "runs"


def test_unique_auto_device_when_calibration_favors_device(monkeypatch):
    """unique_words folds the same measured decision in: identical
    output through the device path above the size gate."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=(70_000, 24)).astype(np.uint8)
    packed = W.pack_words(codes)
    # duplicate some rows so counts differ from all-ones
    packed[1::3] = packed[0::3][: len(packed[1::3])]
    host = unique_words(packed)
    _set_profile(monkeypatch, True, _DEVICE_WINS)
    dev = unique_words(packed)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d)
    monkeypatch.setenv("HUMID_TPU_UNIQUE", "host")
    forced_host = unique_words(packed)
    for h, d in zip(host, forced_host):
        np.testing.assert_array_equal(h, d)


def test_noise_guard_tied_backoff(monkeypatch, tmp_path):
    """Engines tied within measured noise re-measure ONCE; a refresh
    that still measures a tie stamps ``tied_ts`` and later processes
    skip the probe instead of re-paying it every hour forever."""
    import time as _time

    monkeypatch.setenv("HUMID_TPU_CALIB_PATH", str(tmp_path / "c.json"))
    tied = {"neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 105.0,
            "spread": 1.0}  # margin 5% << spread 100%
    calls = []

    def fake_measure():
        calls.append(1)
        return dict(tied, ts=_time.time())

    monkeypatch.setattr(B, "_measure_engines", fake_measure)
    stale = dict(tied, ts=0.0)
    monkeypatch.setitem(B.__dict__, "_CALIB", stale)
    ks = ["neighbors_runs_ns", "neighbors_bucketed_ns"]
    c = B._noise_guarded(stale, ks)
    assert calls == [1] and "tied_ts" in c
    # A later process loads the (again stale) tied entry: no re-measure.
    later = dict(c, ts=0.0)
    assert B._noise_guarded(later, ks) is later
    assert calls == [1]


def test_noise_guard_fresh_or_clear_margin_skips_refresh(monkeypatch):
    """No refresh while the measurement is fresh OR the margin beats the
    measured noise."""
    import time as _time

    def boom():  # pragma: no cover - must not be called
        raise AssertionError("unexpected re-measurement")

    monkeypatch.setattr(B, "_measure_engines", boom)
    ks = ["neighbors_runs_ns", "neighbors_bucketed_ns"]
    fresh_tied = {"neighbors_runs_ns": 100.0,
                  "neighbors_bucketed_ns": 105.0, "spread": 1.0,
                  "ts": _time.time()}
    assert B._noise_guarded(fresh_tied, ks) is fresh_tied
    stale_clear = {"neighbors_runs_ns": 100.0,
                   "neighbors_bucketed_ns": 2000.0, "spread": 1.0,
                   "ts": 0.0}
    assert B._noise_guarded(stale_clear, ks) is stale_clear


def test_mesh_probe_skipped_multiprocess(monkeypatch, tmp_path):
    """The mesh-engine probe runs a shard_map over ALL devices — a
    global collective — so multi-host processes must never launch it
    lazily (deadlock hazard); the row is simply absent there."""
    import jax

    monkeypatch.setenv("HUMID_TPU_CALIB_PATH", str(tmp_path / "c.json"))
    monkeypatch.setitem(B.__dict__, "_CALIB", None)
    monkeypatch.setattr(
        B, "_gen_probe_words",
        lambda n, word_length=24, seed=0: _rand_packed(4096, word_length))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    c = B.engine_constants()
    assert c is not None and "neighbors_sharded_ns" not in c
