"""Small shared host utilities."""

from __future__ import annotations

import os


_malloc_tuned = False

#: Persistent XLA compilation cache of this checkout, used when
#: JAX_COMPILATION_CACHE_DIR is not set.  A fixed path: the directory is
#: part of the cache key, so one that moved between runs would never hit.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory: JAX_COMPILATION_CACHE_DIR when set (JAX reads
    it itself, nothing else is configured), else COMPILE_CACHE_DIR.
    Called by every entry point (CLI, bench, chip smoke) before the
    first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


def tune_malloc() -> None:
    """Keep freed large buffers on the malloc heap instead of returning
    them to the kernel (mmap/munmap per allocation): the pipeline's host
    phases cycle many multi-hundred-MB numpy scratch buffers, and on
    virtualized hosts re-faulting returned pages is erratically slow
    (measured 60x slower than reuse).  With a high mmap threshold + trim
    disabled, pages are faulted once per process and reused by every
    later phase.

    Called from the CLI / pipeline entry points — NOT at package import —
    so merely importing humid_tpu never mutates a host application's
    process-global glibc allocator.  Opt out with
    HUMID_TPU_NO_MALLOC_TUNE=1."""
    global _malloc_tuned
    if _malloc_tuned or os.environ.get("HUMID_TPU_NO_MALLOC_TUNE"):
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except (OSError, AttributeError):  # pragma: no cover - non-glibc
        pass


def nvidia_smi_line() -> str | None:
    """The first card's ``name, power.limit`` as nvidia-smi reports them
    (None where nvidia-smi is absent or fails).  A card set below its
    maximum power limit runs slower under load, so every device number
    is reported beside it."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def avail_bytes(default: int = 1 << 33) -> int:
    """Available physical memory in bytes (``default`` when the sysconf
    probe is unsupported).  Single definition so a future cgroup-aware
    fix lands everywhere at once."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return default


def concat_aranges(lens):
    """[0..lens[0]), [0..lens[1]), ... concatenated, vectorized — the
    within-segment iota of a ragged gather.  Single definition shared
    by the fused decode, the mesh-search run expanders, the ring
    compaction, and the sharded-cluster fallback (a fix to one must
    reach all)."""
    import numpy as np

    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    offs = np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return np.arange(total, dtype=np.int64) - offs
