"""Measure the host-vs-device neighbour-engine crossover.

Times find_neighbor_pairs engines on realistic unique tables of
increasing size, printing one JSON line per (u, engine).  An engine is a
strategy name, optionally with a Hamming impl: ``bucketed:xor``,
``dense:mxu``.  Every line names the device it ran on.

Usage:  python scripts/engine_xover.py [--sizes ...] \
            [--engines runs,bucketed:xor,bucketed:mxu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def gen_uniques(u: int, word_length: int = 24, dup: int = 8,
                seed: int = 0, return_reads: bool = False):
    """Unique packed fingerprints shaped like the bench pipeline's:
    a pool of u/dup distinct words, 30% single substitutions, then
    unique+sort — matches bench.py's dataset statistics.
    ``return_reads`` also returns the PRE-unique packed read array (the
    input unit of the whole-pipeline engines: fused/phasewise)."""
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from humid_tpu import words as W
    from humid_tpu.ops import unique_words

    rng = np.random.default_rng(seed)
    # n = 2u yields only ~0.69u uniques (pool of n/dup + ~0.45u distinct
    # mutants); oversample ~1.5x then slice so the advertised --sizes
    # points are actually measured at those unique counts.
    n = u * 3
    pool = rng.integers(0, 4, size=(n // dup, word_length)).astype(np.uint8)
    codes = pool[rng.integers(0, len(pool), n)].copy()
    mut = rng.random(n) < 0.3
    codes[np.flatnonzero(mut), rng.integers(0, word_length, int(mut.sum()))] = (
        rng.integers(0, 4, int(mut.sum()))
    )
    packed = W.pack_words(codes)
    uniq, _, _, _ = unique_words(packed)
    if return_reads:
        # The read-level engines consume ALL n reads; their rows report
        # the actual unique count of that input.
        return uniq, packed
    if len(uniq) > u:
        # Uniform subsample keeps the table sorted (required contract).
        keep = np.sort(rng.choice(len(uniq), u, replace=False))
        uniq = uniq[keep]
    return uniq


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[1 << 18, 1 << 20, 1 << 22, 1 << 23])
    p.add_argument("--word-length", type=int, default=24)
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--engines", default="runs,bucketed")
    args = p.parse_args()

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from humid_tpu._backend import describe_device
    from humid_tpu._util import configure_compile_cache
    from humid_tpu.ops.neighbors import find_neighbor_pairs

    configure_compile_cache()
    backend = describe_device()
    for u_req in args.sizes:
        whole = [e for e in args.engines.split(",")
                 if e in ("fused", "phasewise_device")]
        table = [e for e in args.engines.split(",") if e not in whole]
        uniq = gen_uniques(u_req, args.word_length)[:u_req]
        for eng in table:
            strategy, _, impl = eng.partition(":")
            kw = dict(strategy=strategy, word_length=args.word_length,
                      impl=impl or None)
            find_neighbor_pairs(uniq, args.m, **kw)  # compile
            best = None
            npairs = 0
            for _ in range(args.runs):
                t0 = time.perf_counter()
                a, b = find_neighbor_pairs(uniq, args.m, **kw)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                npairs = len(a)
            print(json.dumps({
                "u": len(uniq), "engine": eng, "backend": backend,
                "best_s": round(best, 4), "pairs": npairs,
                "ns_per_unique": round(best / len(uniq) * 1e9, 1),
            }), flush=True)
        if not whole:
            continue
        # Whole-pipeline engines: packed READS in, (tables + pairs) out.
        # "phasewise_device" is the sum the fused row must beat: device
        # unique (table down) + runs_device (table + orders back up,
        # bitmaps down).
        from humid_tpu.ops.unique import unique_words_device
        from humid_tpu.ops.runs_device import runs_device_pairs
        from humid_tpu.ops.fused import fused_probe

        _, reads = gen_uniques(u_req, args.word_length, return_reads=True)

        def run_phasewise():
            uq, _, _, _ = unique_words_device(reads, want_inverse=False)
            return uq, runs_device_pairs(
                uq, args.m, word_length=args.word_length)

        def run_fused():
            k, _, _, pr = fused_probe(reads, args.word_length, args.m)
            return k, pr

        for eng, fn in (("phasewise_device", run_phasewise),
                        ("fused", run_fused)):
            if eng not in whole:
                continue
            best = None
            npairs = 0
            uu = 0
            for _ in range(args.runs):
                t0 = time.perf_counter()
                uq, (a, b) = fn()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                npairs = len(a)
                uu = uq if isinstance(uq, int) else len(uq)
            print(json.dumps({
                "u": uu, "n_reads": len(reads), "engine": eng,
                "backend": backend, "best_s": round(best, 4),
                "pairs": npairs,
                "ns_per_unique": round(best / uu * 1e9, 1),
                "ns_per_read": round(best / len(reads) * 1e9, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
