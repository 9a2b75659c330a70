"""End-to-end dedup throughput benchmark.

Measures reads/sec of the full pipeline (FastQ bytes -> packed words ->
unique counting -> device neighbour search -> clustering -> dedup FastQ
output) on a synthetic dataset sized like the reference's own workloads,
and prints ONE JSON line:

  {"metric": "reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": R}

Baseline: the reference publishes no numbers, so the
baseline is MEASURED by timing baseline/humid_ref — the single-core C++
implementation of the reference semantics (trie + asymmetric Hamming
search + directional clustering + dedup output) — on the same dataset
and flags, built on the fly with g++ if needed.  If that fails, the
fallback is the ~40k reads/s estimate from the reference's own
troubleshooting log (22m42s + 17m10s for a WGS-scale run,
/root/reference/docs/troubleshooting.rst:13-15).

Runs on the GPU, and refuses to run elsewhere unless the CPU backend
was asked for explicitly (``JAX_PLATFORMS=cpu``): a CPU number is never
reported as a device number.  The JSON line names the backend, device
kind and count, and the card's name and power limit as nvidia-smi
reports them.  The first invocation pays one jit compile per block
shape, so the timed run is preceded by an untimed warmup over the same
shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_SEC = 40_000.0
BENCH_DIR = os.path.join(tempfile.gettempdir(), "humid_tpu_bench")


def gen_dataset(path: str, n_reads: int, read_len: int = 100,
                dup_factor: int = 8, seed: int = 0) -> None:
    """Synthetic single-end FastQ: ``n_reads`` reads drawn from a pool of
    n_reads/dup_factor distinct sequences, each with a 30% chance of one
    random substitution (near-duplicates for the distance-1 search)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = bases[rng.integers(0, 4, size=(n_reads // dup_factor, read_len))]
    idx = rng.integers(0, len(pool), n_reads)
    seqs = pool[idx].copy()
    mut = rng.random(n_reads) < 0.3
    pos = rng.integers(0, read_len, n_reads)
    seqs[np.flatnonzero(mut), pos[mut]] = bases[
        rng.integers(0, 4, int(mut.sum()))
    ]
    with open(path, "wb") as f:
        chunk = 1 << 18
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            k = hi - lo
            # Fixed-width names "@read<9 digits>": fully vectorized.
            ids = np.arange(lo, hi, dtype=np.int64)
            digits = np.empty((k, 9), np.uint8)
            v = ids
            for p in range(8, -1, -1):
                digits[:, p] = (v % 10) + ord("0")
                v = v // 10
            nlen = 5 + 9  # "@read" + 9 digits
            rec_len = nlen + 1 + read_len + 3 + read_len + 1
            rec = np.full((k, rec_len), ord("I"), np.uint8)
            rec[:, 0:5] = np.frombuffer(b"@read", np.uint8)
            rec[:, 5:14] = digits
            rec[:, 14] = 10
            rec[:, 15:15 + read_len] = seqs[lo:hi]
            rec[:, 15 + read_len] = 10
            rec[:, 16 + read_len] = ord("+")
            rec[:, 17 + read_len] = 10
            # qual region already 'I'-filled
            rec[:, rec_len - 1] = 10
            f.write(rec.tobytes())


def run_once(files, out_dir, **kw):
    from humid_tpu.pipeline import run

    t0 = time.perf_counter()
    res = run(files, dir_name=out_dir, log_name=os.devnull, **kw)
    return time.perf_counter() - t0, res


_MICRO_X = None


def steal_probe() -> float:
    """One sample of a fixed pure-CPU microbenchmark (numpy xor+popcount
    over a resident 8MB array).  The work is constant, so sample-to-sample
    ratios measure hypervisor steal / host contention, not the pipeline.
    Returns seconds."""
    global _MICRO_X
    if _MICRO_X is None:
        _MICRO_X = np.random.default_rng(7).integers(
            0, 2**31, size=1 << 21, dtype=np.int64)
    t0 = time.perf_counter()
    for _ in range(4):
        z = _MICRO_X ^ (_MICRO_X >> 1)
        np.bitwise_count(z).sum()
    return time.perf_counter() - t0


def measure_baseline(fq: str, n_reads: int, distance: int = 1) -> float:
    """Single-core reference-semantics reads/s (baseline/humid_ref),
    on the same dataset AND flags as the timed pipeline."""
    import shutil
    import subprocess

    repo = os.path.dirname(os.path.abspath(__file__))
    exe = os.path.join(repo, "baseline", "humid_ref")
    src = os.path.join(repo, "baseline", "humid_ref.cpp")
    try:
        if not os.path.exists(exe) or (
            os.path.getmtime(exe) < os.path.getmtime(src)
        ):
            gxx = shutil.which("g++")
            if gxx is None:
                return BASELINE_READS_PER_SEC
            subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe, src,
                            "-lz"], check=True)
        out = os.path.join(BENCH_DIR, "out_ref")
        os.makedirs(out, exist_ok=True)
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            subprocess.run([exe, "-m", str(distance), "-d", out, fq],
                           check=True, capture_output=True)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return n_reads / best
    except Exception:
        return BASELINE_READS_PER_SEC


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reads", type=int, default=1_000_000)
    p.add_argument("--distance", type=int, default=1)
    p.add_argument("--no-warmup", action="store_true")
    args = p.parse_args()

    import jax

    from humid_tpu._util import configure_compile_cache, nvidia_smi_line

    backend = jax.default_backend()
    explicit_cpu = os.environ.get("JAX_PLATFORMS", "").lower() == "cpu"
    if backend != "gpu" and not (backend == "cpu" and explicit_cpu):
        print(f"bench: backend {backend!r} is not a GPU (set "
              "JAX_PLATFORMS=cpu to time the CPU backend on purpose)",
              file=sys.stderr)
        return 2
    configure_compile_cache()

    os.makedirs(BENCH_DIR, exist_ok=True)
    fq = os.path.join(BENCH_DIR, f"bench_{args.reads}.fastq")
    if not os.path.exists(fq):
        # Generate to a temp name and rename: an interrupted generation
        # must not leave a truncated file the cache check would reuse
        # (reads_per_sec would divide the full requested count by a
        # partial run's time).
        tmp = f"{fq}.tmp.{os.getpid()}"
        gen_dataset(tmp, args.reads)
        os.replace(tmp, fq)
    files = [fq]

    out_dir = os.path.join(BENCH_DIR, "out")
    kw = dict(distance=args.distance, write_dedup=True)

    if not args.no_warmup:
        # Untimed warmup: same block shapes -> jit cache is hot.
        run_once(files, out_dir, **kw)
    # Best-of-N timed runs (timeit convention): the host shares time
    # with disk writeback and other tenants, so slower samples measure
    # that noise, not the pipeline.  Sampling is adaptive: at least 5 runs, then
    # keep sampling while the best still improves meaningfully, within
    # a wall-clock budget.  The sync drains dirty pages (e.g. from
    # dataset generation) so writeback does not fire mid-measurement.
    try:
        os.sync()
    except AttributeError:
        pass
    budget = max(90.0, args.reads / 80_000)
    t_bench = time.perf_counter()
    dt = None
    n_runs = 0
    since_improve = 0
    samples: list[float] = []
    micro: list[float] = []
    phases_best: dict[str, float] = {}
    micro.append(steal_probe())
    while True:
        d, r = run_once(files, out_dir, **kw)
        micro.append(steal_probe())
        samples.append(d)
        for k, v in r.extra.get("timings", {}).items():
            phases_best[k] = min(phases_best.get(k, v), v)
        n_runs += 1
        if dt is None or d <= dt:
            res = r  # phases reported below come from the best run
        # A sample taken in a window the host probe calls noisy (>1.5x
        # this bench's own quiet floor) could not have shown the
        # pipeline's real speed, so it does not count toward convergence
        # — the sampler keeps going (within budget) until a quiet window
        # produced the plateau.
        noisy = micro[-1] > 1.5 * min(micro)
        if dt is None or d < dt * 0.98:
            dt = min(dt, d) if dt is not None else d
            since_improve = 0
        else:
            dt = min(dt, d)
            if not noisy:
                since_improve += 1
        # Convergence needs >= 7 samples; the wall-clock budget may cut
        # sampling off earlier (>= 3) so a contended host does not
        # grind through every sample regardless.
        over_budget = time.perf_counter() - t_bench > budget
        if (n_runs >= 7 and since_improve >= 4) or (
                n_runs >= 3 and over_budget):
            break

    rps = args.reads / dt
    base_rps = measure_baseline(fq, args.reads, args.distance)

    phases = {
        k: round(v, 3)
        for k, v in res.extra.get("timings", {}).items()
    }
    # Host-steal evidence.  The microbenchmark does
    # CONSTANT work, so steal_factor = median/best across its samples
    # is pure environment noise: >~1.3 means the host was contended
    # during this bench and even the best pipeline sample likely ate
    # steal — read `value` (best-of-N) with that in mind, and expect
    # documented numbers from quiet windows to be higher.
    ms = sorted(micro)
    steal_factor = ms[len(ms) // 2] / ms[0] if ms and ms[0] > 0 else 1.0
    ss = sorted(samples)
    print(json.dumps({
        "metric": "reads_per_sec",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / base_rps, 2),
        # The denominator, so an odd ratio is decomposable: the baseline
        # is MEASURED (2 runs of baseline/humid_ref) and shares this
        # host's steal.
        "baseline_reads_per_sec": round(base_rps, 1),
        "backend": backend,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        # nvidia-smi "name, power.limit" (None off a GPU host): a card
        # below its maximum limit runs slower under load.
        "card": nvidia_smi_line(),
        # Where the neighbour phase actually ran: strategy "runs" is the
        # host engine; "bucketed"/"dense"/"runs_device"/"sharded*"/
        # "fused" are device engines.
        "engine": res.extra.get("engine", {}).get("strategy"),
        "n_runs": n_runs,
        "value_median": round(args.reads / ss[len(ss) // 2], 1),
        "steal_factor": round(steal_factor, 2),
        "phases": phases,
        # Per-phase minimum across ALL runs: a contended host rarely
        # yields one run where every phase is clean, so the per-phase
        # floor is the better estimate of the pipeline's real cost.
        "phases_best": {k: round(v, 3) for k, v in phases_best.items()},
    }))
    print(f"# baseline humid_ref: {base_rps:.0f} reads/s", file=sys.stderr)
    print(
        f"# {args.reads} reads in {dt:.2f}s; unique={res.unique} "
        f"clusters={res.clusters} total={res.total}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
