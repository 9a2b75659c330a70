"""Backend engine profiling + calibration: should hot phases run on-device?

Two layers decide the production route:

1. ``backend_profile()`` — which JAX backend this process runs on.  A
   local GPU is "co-located": its device engines are eligible.  The CPU
   backend is host-routed (the documented CPU mode).
2. ``engine_constants()`` / ``use_device_engine()`` — eligibility is not
   a choice: the host and device engines are both linear in input size,
   so a one-time measurement of each engine's per-row cost on THIS
   machine (disk-cached per device kind + core count) decides the
   route.

Env overrides:

  HUMID_TPU_DEVICE_ENGINE=1|device|on   force the device engines
  HUMID_TPU_DEVICE_ENGINE=0|host|off    force the host engines
  HUMID_TPU_CALIBRATION=off             skip calibration (co-location
                                        alone then opts in)
  HUMID_TPU_RECALIBRATE=1               re-measure, ignore the cache
  HUMID_TPU_CALIB_PATH                  cache file location
"""

from __future__ import annotations

import os
import time

_PROFILE: dict | None = None


def backend_profile(refresh: bool = False) -> dict:
    """Cached probe: {"backend", "colocated_device", "forced"}.

    ``colocated_device`` is True on a local GPU backend, False on the
    CPU backend; HUMID_TPU_DEVICE_ENGINE forces either answer.
    """
    global _PROFILE
    if _PROFILE is not None and not refresh:
        return _PROFILE

    import jax

    forced_env = os.environ.get("HUMID_TPU_DEVICE_ENGINE", "").lower()
    forced: bool | None = None
    backend = jax.default_backend()
    if forced_env in ("1", "device", "on"):
        colocated = forced = True
    elif forced_env in ("0", "host", "off"):
        colocated = forced = False
    else:
        colocated = backend == "gpu"
    _PROFILE = {
        "backend": backend,
        "colocated_device": colocated,
        "forced": forced,
    }
    return _PROFILE


def describe_device() -> str:
    """``<backend> <device_kind> x<local device count>``: the machine a
    run's device phases use, for logs and benchmark lines."""
    import jax

    return (f"{jax.default_backend()} {jax.devices()[0].device_kind} "
            f"x{len(jax.local_devices())}")


# ---------------------------------------------------------------------------
# Engine calibration: measure, don't guess.
#
# Having a device is not evidence that the device engines are faster:
# the host pigeonhole merge join is algorithmically leaner than brute
# tile scans, so which side wins depends on the card and the host's
# cores.  Both sides are linear, so a single measured constant per
# engine decides the route for every size.  The constants are measured
# once per (device kind, host core count) on first qualifying use and
# cached on disk — the decision is measurement, not env vars.
# ---------------------------------------------------------------------------

#: bump when an engine's cost profile changes materially (invalidates
#: cached calibrations).
_CALIB_VERSION = 5

_CALIB: dict | None = None


def _calib_path() -> str:
    return os.environ.get(
        "HUMID_TPU_CALIB_PATH",
        os.path.join(os.path.expanduser("~"), ".cache", "humid_tpu",
                     "engine_calib.json"))


def _calib_key() -> str:
    import jax

    kind = jax.devices()[0].device_kind
    # Local device count is part of the key: the mesh engine is only
    # measured (and routable) with >1 co-located chip, so a cache row
    # from a different topology must not be reused.
    return (f"v{_CALIB_VERSION}|{kind}|ncpu={os.cpu_count()}"
            f"|ndev={len(jax.local_devices())}")


def _gen_probe_words(n: int, word_length: int = 24, seed: int = 0):
    """Synthetic packed words with bench-like duplicate structure."""
    import numpy as np

    from . import words as W

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(n // 8, word_length)).astype(np.uint8)
    codes = pool[rng.integers(0, len(pool), n)].copy()
    mut = rng.random(n) < 0.3
    codes[np.flatnonzero(mut),
          rng.integers(0, word_length, int(mut.sum()))] = (
        rng.integers(0, 4, int(mut.sum())))
    return W.pack_words(codes)


def _measure_engines() -> dict:
    """Time host vs device engines on small representative workloads.
    Best-of-N per engine; the per-sample spread is recorded so
    use_device_engine can tell a real margin from measurement noise."""
    import sys

    import numpy as np

    from .ops import unique_words
    from .ops.unique import unique_words_device
    from .ops.neighbors import find_neighbor_pairs

    print("# humid_tpu: calibrating host vs device engines "
          "(one-time per device kind; cached)", file=sys.stderr)
    wl = 24
    packed = _gen_probe_words(1 << 19, wl)

    spreads: list[float] = []

    def best(fn, n=3):
        fn()  # warmup: jit compile / page faults outside the timing
        samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        b = min(samples)
        spreads.append(max(samples) / b - 1.0 if b > 0 else 0.0)
        return b

    t_uh = best(lambda: unique_words(packed, _force_host=True))
    t_ud = best(lambda: unique_words_device(packed))
    uniq, counts = unique_words(packed, _force_host=True)[:2]
    u = len(uniq)
    t_nr = best(lambda: find_neighbor_pairs(
        uniq, 1, strategy="runs", word_length=wl))
    t_nd = best(lambda: find_neighbor_pairs(
        uniq, 1, strategy="bucketed", word_length=wl))
    t_nrd = best(lambda: find_neighbor_pairs(
        uniq, 1, strategy="runs_device", word_length=wl))
    # Mesh engine: only meaningful with >1 co-located chip (on a single
    # chip the sharded path is the bucketed path plus collective
    # overhead, so it is skipped and never routed to).  Single-process
    # only: the probe's shard_map runs over data_mesh() = ALL devices,
    # and in a multi-host job a lazily triggered calibration on one host
    # would execute a global collective its peers never enter
    # (deadlock).  Multi-host runs adopt host 0's engine decision via
    # broadcast_engine_choice, so the mesh row is simply absent there.
    import jax

    t_ns = None
    if len(jax.local_devices()) > 1 and jax.process_count() == 1:
        t_ns = best(lambda: find_neighbor_pairs(
            uniq, 1, strategy="sharded_bucketed", word_length=wl))

    # -x clustering: host exact flood fill vs device label propagation
    # + bit-exact host finalize (the production device route in
    # pipeline.cluster_dispatch).
    from .ops import pairs_to_csr
    from .cluster import connected_components_device
    from .cluster.exact import cluster_exact, cluster_max_from_components

    pa, pb = find_neighbor_pairs(uniq, 1, strategy="runs", word_length=wl)
    indptr, indices = pairs_to_csr(pa, pb, u)
    t_ch = best(lambda: cluster_exact(counts, indptr, indices,
                                      maximum=True))
    t_cd = best(lambda: cluster_max_from_components(
        counts, indptr, indices,
        connected_components_device(pa, pb, u)))

    # Fused device-resident pipeline (unique + partition sorts +
    # sweeps all on-chip, VERDICT r4 #1): measured end-to-end from
    # packed reads so its constant is comparable to
    # unique_*_ns + neighbors_*_ns * (probe_u / probe_n).
    from .ops.fused import fused_probe

    t_fp = best(lambda: fused_probe(packed, wl, 1))
    return {
        "unique_host_ns": round(t_uh / len(packed) * 1e9, 2),
        "unique_device_ns": round(t_ud / len(packed) * 1e9, 2),
        "neighbors_runs_ns": round(t_nr / u * 1e9, 2),
        "neighbors_bucketed_ns": round(t_nd / u * 1e9, 2),
        "neighbors_runs_device_ns": round(t_nrd / u * 1e9, 2),
        **({"neighbors_sharded_ns": round(t_ns / u * 1e9, 2)}
           if t_ns is not None else {}),
        "cc_host_ns": round(t_ch / u * 1e9, 2),
        "cc_device_ns": round(t_cd / u * 1e9, 2),
        "pipeline_fused_ns": round(t_fp / len(packed) * 1e9, 2),
        # Worst relative per-sample spread (max/best - 1) across all
        # measured engines: the noise floor for routing decisions.
        "spread": round(max(spreads), 3) if spreads else 0.0,
        "probe_n": len(packed), "probe_u": u,
        "ts": time.time(),
    }


def engine_constants(refresh: bool = False) -> dict | None:
    """Measured engine cost constants for this machine (disk-cached per
    device kind + core count), or None when disabled via
    HUMID_TPU_CALIBRATION=off.  HUMID_TPU_RECALIBRATE=1 forces a fresh
    measurement."""
    global _CALIB
    if os.environ.get("HUMID_TPU_CALIBRATION", "").lower() in (
            "off", "0", "no"):
        return None
    if _CALIB is not None and not refresh:
        return _CALIB
    import json

    path = _calib_path()
    key = _calib_key()
    # Always load the existing file: a refresh replaces only THIS key's
    # entry, never calibrations for other device kinds / core counts.
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    if (key in cache and not refresh
            and not os.environ.get("HUMID_TPU_RECALIBRATE")):
        _CALIB = cache[key]
        return _CALIB
    _CALIB = _measure_engines()
    _save_calib(_CALIB)
    return _CALIB


def _save_calib(entry: dict) -> None:
    """Persist this machine's calibration entry, merging (never
    clobbering) other device kinds' / topologies' rows."""
    import json

    path = _calib_path()
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    cache[_calib_key()] = entry
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only home: keep the in-process calibration


#: neighbour engines eligible for auto-routing, keyed by the
#: find_neighbor_pairs strategy name; values are calibration keys.
_NEIGHBOR_ENGINES = {
    "runs": "neighbors_runs_ns",                    # host
    "bucketed": "neighbors_bucketed_ns",            # device tile scan
    "runs_device": "neighbors_runs_device_ns",      # device run sweeps
    "sharded_bucketed": "neighbors_sharded_ns",     # local device mesh
}

#: engines that honor find_neighbor_pairs' host ``shard`` partition
#: (the mesh engines search their full local slice instead).
_SHARDABLE_ENGINES = {"runs", "bucketed", "runs_device"}

def _noise_guarded(c: dict, ks: list[str]) -> dict:
    """Noise guard: a single skewed calibration window (a busy host)
    could permanently pin the route.  When the
    best two engines' margin is within the measured per-sample spread
    AND the cached measurement is stale, re-measure once."""
    vals = sorted(float(c[k]) for k in ks if k in c)
    if len(vals) < 2:
        return c
    noise = float(c.get("spread", 0.0))
    margin = (vals[1] - vals[0]) / max(vals[0], 1e-9)
    age_s = time.time() - float(c.get("ts", 0.0))
    if margin >= noise or age_s <= 3600.0:
        return c
    # Engines GENUINELY tied within this host's noise would otherwise
    # re-pay the multi-second probe in every process started >1h after
    # the last one, forever: a refresh that still measures a tie stamps
    # ``tied_ts`` and suppresses further noise refreshes for 30 days
    # (either engine is fine while they tie).
    if time.time() - float(c.get("tied_ts", 0.0)) < 30 * 86400.0:
        return c
    c2 = engine_constants(refresh=True)
    if c2 is None:
        # HUMID_TPU_CALIBRATION was toggled off between calls: keep the
        # cached constants rather than crash on the None refresh.
        return c
    c = c2
    vals = sorted(float(c[k]) for k in ks if k in c)
    if len(vals) >= 2 and ((vals[1] - vals[0]) / max(vals[0], 1e-9)
                           < float(c.get("spread", 0.0))):
        c["tied_ts"] = time.time()
        _save_calib(c)
    return c


def pick_neighbor_engine(shardable_only: bool = False) -> str:
    """The auto-routed neighbour engine (a find_neighbor_pairs strategy
    name): the MEASURED fastest of host runs / device bucketed / device
    run sweeps / (with >1 local chip) bucketed mesh search on this
    machine, with a 10% hysteresis favoring the host engine so noise
    does not flap the route.  HUMID_TPU_DEVICE_ENGINE=1/0 forces the
    device/host side (among device engines the measured best still
    wins).  ``shardable_only`` restricts the choice to engines that
    honor find_neighbor_pairs' host ``shard`` work partition (the mesh
    strategies search their full local slice instead — correct but not
    work-proportional under host shards)."""
    prof = backend_profile()
    forced = prof.get("forced")
    if forced is False or (forced is None
                           and not prof["colocated_device"]):
        return "runs"
    c = engine_constants()
    if c is None:  # calibration disabled: colocated alone opts in
        return "runs_device"
    if any(v not in c for v in ("neighbors_runs_ns",
                                "neighbors_bucketed_ns",
                                "neighbors_runs_device_ns")):
        c = engine_constants(refresh=True)  # stale cache: re-measure
    keys = [k for k in _NEIGHBOR_ENGINES.values() if k in c]
    c = _noise_guarded(c, keys)
    host = float(c["neighbors_runs_ns"])
    dev_engines = {s: float(c[k]) for s, k in _NEIGHBOR_ENGINES.items()
                   if s != "runs" and k in c
                   and not (shardable_only
                            and s not in _SHARDABLE_ENGINES)}
    best_dev = min(dev_engines, key=dev_engines.get)
    if forced is True:
        return best_dev
    return best_dev if dev_engines[best_dev] < 0.9 * host else "runs"


def use_device_engine(kind: str) -> bool:
    """Route a hot phase to the device engine?  True only when the chip
    is co-located AND the measured constants say the device engine is
    faster on this machine (with a 10% hysteresis margin so noise does
    not flap the route).  ``kind``: "neighbors", "unique" or "cc"
    (the -x connected-components route in pipeline.cluster_dispatch).

    HUMID_TPU_DEVICE_ENGINE=1/0 still forces the answer outright.
    """
    if kind == "neighbors":
        return pick_neighbor_engine() != "runs"
    prof = backend_profile()
    if prof.get("forced") is not None:
        return bool(prof["forced"])
    if not prof["colocated_device"]:
        return False
    c = engine_constants()
    if c is None:  # calibration disabled: colocated alone opts in
        return True
    keys = {"unique": ("unique_device_ns", "unique_host_ns"),
            "cc": ("cc_device_ns", "cc_host_ns")}
    if kind not in keys:
        raise ValueError(f"unknown engine kind {kind!r}")
    dev_k, host_k = keys[kind]
    if dev_k not in c or host_k not in c:  # stale cache: re-measure
        c = engine_constants(refresh=True)
    c = _noise_guarded(c, [dev_k, host_k])
    return c[dev_k] < 0.9 * c[host_k]


def use_fused_pipeline() -> bool:
    """Route the whole unique->neighbours stretch through the fused
    device-resident pipeline (ops/fused.py)?  True when forced via
    HUMID_TPU_FUSED=1, or when the chip is co-located AND the measured
    end-to-end constant beats the best phase-wise alternative (host or
    device unique + best neighbour engine) with the usual 10%
    hysteresis.  A calibration cache that predates the fused probe
    answers False rather than re-measuring mid-run (the next natural
    recalibration — _CALIB_VERSION bump — adds the constant)."""
    env = os.environ.get("HUMID_TPU_FUSED", "").lower()
    if env in ("1", "on", "fused"):
        return True
    if env in ("0", "off"):
        return False
    prof = backend_profile()
    if prof.get("forced") is False:
        return False
    if not prof["colocated_device"]:
        return False
    c = engine_constants()
    if c is None:  # calibration disabled: colocated alone opts in
        return True
    need = ("pipeline_fused_ns", "unique_host_ns", "neighbors_runs_ns",
            "probe_n", "probe_u")
    if any(kk not in c for kk in need):
        return False
    ratio = float(c["probe_u"]) / max(float(c["probe_n"]), 1.0)
    best_unique = min(float(c["unique_host_ns"]),
                      float(c.get("unique_device_ns", float("inf"))))
    best_nb = min(float(c[k]) for k in _NEIGHBOR_ENGINES.values()
                  if k in c)
    alt = best_unique + best_nb * ratio
    return float(c["pipeline_fused_ns"]) < 0.9 * alt


def _reset_profile_for_tests() -> None:
    global _PROFILE, _CALIB
    _PROFILE = None
    _CALIB = None
