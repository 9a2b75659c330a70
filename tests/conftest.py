import os

# Tests run on a virtual 8-device CPU mesh; env must be set before jax
# initializes a backend.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
# Strip any inherited device-count flag (a leftover =1 from another tool
# would silently shrink the documented 8-device mesh), then force 8.
_flags = " ".join(f for f in _flags.split()
                  if "xla_force_host_platform_device_count" not in f)
os.environ["XLA_FLAGS"] = (
    _flags + " --xla_force_host_platform_device_count=8"
).strip()

# Distributed tests run on tiny tables that sit far below the sharded
# cluster phase's size gate; force the sharded path so its correctness
# (owned-component walks + DCN merge) is exercised everywhere.  The
# replicated path keeps its own explicit test
# (test_distributed_pipeline.test_replicated_cluster_path).
os.environ.setdefault("HUMID_TPU_CLUSTER_SHARDED", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = ("humid_tpu/_hostops", "humid_tpu/cluster/_ccluster",
           "humid_tpu/io/_cfastqio")


def _native_missing() -> bool:
    from importlib.machinery import EXTENSION_SUFFIXES

    return not all(
        any(os.path.exists(os.path.join(REPO, m + sfx))
            for sfx in EXTENSION_SUFFIXES)
        for m in _NATIVE)


def pytest_configure(config):
    """Build the native extensions from csrc/ when they are missing.

    The package binds its native entry points when it is imported, and
    collection imports it, so the build runs here — before collection —
    rather than in a fixture.  A file lock makes the xdist controller
    and its workers build at most once."""
    if not _native_missing():
        return
    import fcntl
    import subprocess
    import sys

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _native_missing():
            return
        r = subprocess.run(
            [sys.executable, "setup.py", "-q", "build_ext", "--inplace"],
            cwd=REPO, capture_output=True, text=True)
        if r.returncode:
            print(f"conftest: native build failed:\n{r.stderr[-2000:]}",
                  file=sys.stderr)
