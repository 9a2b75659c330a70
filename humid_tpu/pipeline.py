"""End-to-end deduplication pipeline.

JAX rebuild of the reference's ``humid()`` driver (humid.cc:369-409):

  pass 1  read + pack words     (host, vectorized)     <- readData
  unique  sort/unique counting  (host or device)       <- trie leaf counts
  search  XOR+popcount blocks   (host or device, jax)  <- asymmetricHamming
  cluster exact traversal       (host/C++, iterative)  <- cluster.cc
  pass 2  write outputs         (host, streaming)      <- writeFiltered/
                                                          writeAnnotated

The output contract (duplicate sets, annotations, statistics files, file
naming, log phases) is bit-compatible with the reference binary.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import words as W
from .io import FastqWriter, make_file_names, peek_first_record, read_tuples
from .ops import find_neighbor_pairs, pairs_to_csr, unique_words
from .cluster import cluster_exact
from .phaselog import PhaseLog
from .stats import write_statistics


@dataclass
class PipelineResult:
    total: int = 0
    usable: int = 0
    unique: int = 0
    clusters: int = 0
    # Arrays for inspection/testing:
    labels: np.ndarray | None = None        # [U] cluster id per unique word
    counts: np.ndarray | None = None        # [U] duplicate count
    rep_reads: np.ndarray | None = None     # representative read indices
    # [N] id per read (0=filtered); only populated when the run computes
    # per-read ids, i.e. write_annotated=True — None otherwise.
    cluster_of_read: np.ndarray | None = None
    degree: np.ndarray | None = None        # [U] neighbour count
    sizes: np.ndarray | None = None         # [K] cluster sizes
    extra: dict = field(default_factory=dict)


def log_device(log: PhaseLog) -> None:
    """First phase line of a run: the backend and device kind that do
    the work (backend initialization is what it times)."""
    import time as _time

    from ._backend import describe_device

    t0 = _time.time()
    dev = describe_device()
    log.start(f"Using {dev}")
    log.end(t0)


def peek_umi_size(path: str) -> int:
    """UMI length of the first record of ``path`` (humid.cc:24-33)."""
    name, _seq = peek_first_record(path)
    return len(W.extract_umi(name.decode("latin1")))


try:
    from .io._fastqio import encode_pack as _encode_pack
    from .io._fastqio import gather_prefix as _gather_prefix
except ImportError:  # pragma: no cover - extension not built
    _encode_pack = _gather_prefix = None


def _batch_words(batches, nt_to_take, header_umi_size):
    """One batch tuple -> (packed [n, W], filtered [n]), via the fused
    native path (gather + encode + pack in C) when available."""
    n = batches[0].n
    wl = header_umi_size + sum(nt_to_take)
    if _encode_pack is not None:
        b0 = batches[0]
        if (header_umi_size == 0 and len(batches) == 1
                and b0.prefix is not None
                and b0.prefix.shape[1] == nt_to_take[0]):
            # Single-file, no-UMI fast path: the fused framing-time
            # prefix IS the word chars matrix — encode it directly.
            return _encode_pack(b0.prefix)
        chars = np.empty((n, wl), np.uint8)
        col = 0
        if header_umi_size > 0:
            chars[:, :header_umi_size] = W.extract_umi_matrix(
                b0.name_matrix(), header_umi_size,
                lens=b0.ends[:, 0] - b0.starts[:, 0],
            )
            col = header_umi_size
        for b, k in zip(batches, nt_to_take):
            if k:
                if b.prefix is not None and b.prefix.shape[1] == k:
                    # Row-contiguous copy of the framing-time gather.
                    chars[:, col:col + k] = b.prefix
                else:
                    _gather_prefix(b.buf, b.starts[:, 1], b.ends[:, 1],
                                   chars, col, k)
                col += k
        return _encode_pack(chars)
    umi_chars = None
    if header_umi_size > 0:
        umi_chars = W.extract_umi_matrix(
            batches[0].name_matrix(), header_umi_size,
            lens=batches[0].ends[:, 0] - batches[0].starts[:, 0],
        )
    seq_chars = [b.seq_prefix(k) for b, k in zip(batches, nt_to_take)]
    codes, filtered = W.build_words(umi_chars, seq_chars)
    return W.pack_words(codes), filtered


def _input_bytes_estimate(files) -> int:
    """Approximate in-memory size of the parsed inputs (gz assumed ~4x).
    Gzip is detected by CONTENT (magic bytes), matching the reader's
    sniffing — a gzipped file without the .gz suffix must not be
    underestimated 4x (the fused feeder sizes its device buffer from
    this)."""
    total = 0
    for f in files:
        try:
            sz = os.path.getsize(f)
            gz = _is_gzip_file(f)
        except OSError:
            return 1 << 62
        total += sz * 4 if gz else sz
    return total


try:
    from ._hostops import merge_unique_runs as _merge_unique_runs
except ImportError:  # pragma: no cover - extension not built
    _merge_unique_runs = None


def _combine_key64(packed: np.ndarray) -> np.ndarray:
    key = packed[:, 0].astype(np.uint64) << np.uint64(32)
    if packed.shape[1] == 2:
        key |= packed[:, 1].astype(np.uint64)
    return key


def _pass1_overlapped(files, nt_to_take, header_umi_size, batch_records,
                      cache: list | None, want_inverse: bool,
                      run_rows: int = 8 << 20, span_accs: list | None = None):
    """Pass 1 fused with unique counting (words <= 2 lanes).

    Packing jobs also emit (usable key, global read index) pairs; bounded
    runs are sorted on the same pool while the reader streams, and one
    fused k-way merge (csrc/hostops.cpp merge_unique_runs) builds the
    global unique table — the visible post-read cost is ~one pass over
    the keys instead of a full radix sort.

    Returns (total, usable, uniq [U, W] uint32, counts, first_occ
    [GLOBAL read indices], inv_by_read [N] or None).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from .ops.unique import _stable_argsort_u64

    wl = header_umi_size + sum(nt_to_take)
    w = W.num_lanes(wl)
    state = {"total": 0, "acc_n": 0}
    acc_k: list[np.ndarray] = []
    acc_i: list[np.ndarray] = []
    runs: list = []
    sort_futs: list = []

    def _pack(batches, base):
        packed, filtered = _batch_words(batches, nt_to_take,
                                        header_umi_size)
        if filtered.any():
            keep = ~filtered
            keys = _combine_key64(packed[keep])
            gidx = base + np.flatnonzero(keep)
        else:
            keys = _combine_key64(packed)
            gidx = np.arange(base, base + len(packed), dtype=np.int64)
        # Skip the span math for files whose accumulator is already
        # invalidated (CRLF / over budget) — reading acc["ok"] from the
        # pool is GIL-safe, and _span_stitch would only discard it.
        spans = ([_span_batch_part(b, a["hdr_parts"] is not None)
                  if a["ok"] else None
                  for b, a in zip(batches, span_accs)]
                 if span_accs is not None else None)
        return keys, gidx, spans

    def _sort_run(parts_k, parts_i):
        k = parts_k[0] if len(parts_k) == 1 else np.concatenate(parts_k)
        i = parts_i[0] if len(parts_i) == 1 else np.concatenate(parts_i)
        o = _stable_argsort_u64(k)
        return k[o], i[o]

    with ThreadPoolExecutor(max_workers=3) as ex:
        inflight: deque = deque()

        def _drain_one():
            # FIFO drain == stream order (span stitching relies on it).
            keys, gidx, spans = inflight.popleft().result()
            if spans is not None:
                for part, acc in zip(spans, span_accs):
                    _span_stitch(part, acc)
            acc_k.append(keys)
            acc_i.append(gidx)
            state["acc_n"] += len(keys)
            if state["acc_n"] >= run_rows:
                sort_futs.append(ex.submit(_sort_run, list(acc_k),
                                           list(acc_i)))
                acc_k.clear()
                acc_i.clear()
                state["acc_n"] = 0

        for batches in read_tuples(files, batch_records,
                                   prefix_ks=nt_to_take):
            if cache is not None:
                cache.append(batches)
            inflight.append(ex.submit(_pack, batches, state["total"]))
            state["total"] += batches[0].n
            while len(inflight) > 4:
                _drain_one()
        while inflight:
            _drain_one()
        if state["acc_n"]:
            sort_futs.append(ex.submit(_sort_run, acc_k, acc_i))
        runs = [f.result() for f in sort_futs]

    total = state["total"]
    if not runs or not sum(len(r[0]) for r in runs):
        return (total, 0, np.zeros((0, w), np.uint32),
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.full(total, -1, np.int64) if want_inverse else None)
    keys_cat = np.concatenate([r[0] for r in runs])
    idx_cat = np.concatenate([r[1] for r in runs])
    offs = np.cumsum(
        [0] + [len(r[0]) for r in runs]).astype(np.int64)
    runs.clear()
    n_us = len(keys_cat)
    uk = np.empty(n_us, np.uint64)
    counts = np.empty(n_us, np.int64)
    first_occ = np.empty(n_us, np.int64)
    inv = (np.full(total, -1, np.int64) if want_inverse
           else np.empty(1, np.int64))
    k = _merge_unique_runs(keys_cat, idx_cat, offs, uk, counts,
                           first_occ, int(want_inverse), inv)
    uniq = np.empty((k, w), np.uint32)
    uniq[:, 0] = (uk[:k] >> np.uint64(32)).astype(np.uint32)
    if w == 2:
        uniq[:, 1] = uk[:k].astype(np.uint32)
    counts = counts[:k].copy()
    first_occ = first_occ[:k].copy()
    return (total, n_us, uniq, counts, first_occ,
            inv if want_inverse else None)


def _span_acc_new(budget_entries: int, with_hdr: bool = False) -> dict:
    """Accumulator for one file's absolute record-span table (filled by
    ``_span_batch_part`` + ``_span_stitch``).  ``with_hdr`` also collects
    per-record header-line lengths (4B/record) so the annotated writer
    can splice ``:<id>`` after the name without re-framing pass 2."""
    return {"ok": True, "base": 0, "parts": [], "entries": 0,
            "budget": budget_entries,
            "hdr_parts": [] if with_hdr else None}


def _span_batch_part(b, with_hdr: bool = False):
    """Per-batch span math (pool-side, GIL-friendly numpy): relative
    record start offsets within the batch's raw byte run, the run's
    total raw length, and the LF-only validity flag (plus header-line
    lengths when ``with_hdr``).

    Records tile the (decompressed) file, so record i's raw byte length
    is its line contents + 4 newlines — buffer layout (chunk views,
    lockstep re-batching concatenations) never matters.  That identity
    only holds for LF-only files; any ``\\r`` at a line end invalidates
    the table (pass 2 falls back to the re-reading writer)."""
    if b.n == 0:
        return (np.zeros(0, np.int64), 0, True,
                np.zeros(0, np.int32) if with_hdr else None)
    idx = np.minimum(b.ends.reshape(-1), len(b.buf) - 1)
    if bool((b.buf[idx] == 13).any()):
        return None, 0, False, None
    content = (b.ends - b.starts).sum(axis=1, dtype=np.int64) + 4
    cum = np.cumsum(content)
    hdr = ((b.ends[:, 0] - b.starts[:, 0]).astype(np.int32)
           if with_hdr else None)
    return cum - content, int(cum[-1]), True, hdr


def _span_stitch(part, acc: dict) -> None:
    """Append one batch's relative span table to the file accumulator
    (main thread, in batch order).  Offsets let the dedup pass copy the
    SELECTED records' raw bytes straight out of an mmap of the input,
    skipping the second framing scan entirely (the raw bytes equal the
    canonical 4-line record exactly when LF-only — same output as
    build_records)."""
    if part is None or not acc["ok"]:
        return
    rel, total, ok, hdr = part
    if not ok:
        acc["ok"] = False
        acc["parts"] = []
        acc["hdr_parts"] = [] if acc["hdr_parts"] is not None else None
        return
    acc["entries"] += len(rel)
    if acc["entries"] > acc["budget"]:
        acc["ok"] = False
        acc["parts"] = []
        acc["hdr_parts"] = [] if acc["hdr_parts"] is not None else None
        return
    acc["parts"].append(acc["base"] + rel)
    if acc["hdr_parts"] is not None:
        acc["hdr_parts"].append(hdr)
    acc["base"] += total


def cluster_dispatch(counts, indptr, indices, *, maximum: bool,
                     pairs=None, device_threshold: int = 1 << 14):
    """Route clustering to the right engine (VERDICT r2 #7).

    ``-x`` (maximum) clustering on a CO-LOCATED GPU backend with a large
    unique table runs connected components on-device (label propagation,
    cluster/labelprop.py) and finalizes ids/size/maxCount/maxLeaf
    bit-exactly on host (cluster_max_from_components — only components
    with a shared max count re-walk the DFS tie-break).  Directional
    clustering defaults to the native host walk (the measured winner,
    docs/design.md §4); ``HUMID_TPU_CLUSTER=device`` opts into the
    round-5 device formulation (cluster/directional_device.py, within
    its int32 count-doubling range).
    """
    if maximum and pairs is not None and len(counts) > device_threshold:
        from ._backend import use_device_engine

        if use_device_engine("cc"):
            from .cluster import connected_components_device
            from .cluster.exact import cluster_max_from_components

            cc = connected_components_device(pairs[0], pairs[1],
                                             len(counts))
            return cluster_max_from_components(counts, indptr, indices,
                                               cc)
    if (not maximum and pairs is not None
            and os.environ.get("HUMID_TPU_CLUSTER") == "device"
            and (len(counts) == 0
                 or int(np.max(counts)) < (1 << 30))):
        # Off-by-default device formulation of DIRECTIONAL clustering
        # (SURVEY §7 step 5): per-component rounds of masked climbs +
        # descent spreads, bit-exact vs the host walk (validated by
        # fuzz).  The host walk stays the measured default
        # (docs/design.md §4 round-5 analysis) and also serves counts
        # beyond the device formulation's int32 doubling range.
        from .cluster.directional_device import (
            cluster_directional_device)

        return cluster_directional_device(counts, pairs[0], pairs[1])
    return cluster_exact(counts, indptr, indices, maximum=maximum)


from .io.reader import is_gzip_file as _is_gzip_file  # noqa: E402


def _pass1(files, nt_to_take, header_umi_size, batch_records,
           cache: list | None = None, pack_workers: int = 3,
           span_accs: list | None = None, feeder=None):
    """Stream all files in lockstep; return (packed [N,W], filtered [N]).
    When ``cache`` is a list, parsed batch tuples are appended to it for
    reuse by the output pass.  When ``span_accs`` is given (one
    accumulator per file), absolute record spans are collected for the
    span-based dedup writer.  When ``feeder`` (an
    ops.fused.DeviceFeeder) is given, packed batches stream to the
    device DURING framing instead of accumulating on the host — the
    fused pipeline's h2d overlap — and the packed return value is None.

    Packing (UMI gather + base encode, all GIL-releasing C calls) runs on
    a small thread pool so it overlaps the reader thread's
    decompression + framing; in-flight futures are bounded so memory
    stays proportional to the pool size."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    packed_parts: list[np.ndarray] = []
    filt_parts: list[np.ndarray] = []

    def _work(batches):
        packed, filtered = _batch_words(batches, nt_to_take,
                                        header_umi_size)
        spans = None
        if span_accs is not None:
            # acc["ok"] read from the pool is GIL-safe; once a file's
            # accumulator is invalidated its span math is dead work.
            spans = [_span_batch_part(b, a["hdr_parts"] is not None)
                     if a["ok"] else None
                     for b, a in zip(batches, span_accs)]
        return packed, filtered, spans

    def _drain(fut):
        # FIFO drain == submission order, so span stitching sees batches
        # in stream order (and feeder rows land at their global read
        # index).
        packed, filtered, spans = fut.result()
        if feeder is not None:
            # The feeder holds only USABLE rows (usable index space);
            # compact out filtered rows before upload.
            feeder.push(packed[~filtered] if filtered.any() else packed)
        else:
            packed_parts.append(packed)
        filt_parts.append(filtered)
        if spans is not None:
            for part, acc in zip(spans, span_accs):
                _span_stitch(part, acc)

    with ThreadPoolExecutor(max_workers=max(1, pack_workers)) as ex:
        inflight: deque = deque()
        for batches in read_tuples(files, batch_records,
                                   prefix_ks=nt_to_take):
            if cache is not None:
                cache.append(batches)
            inflight.append(ex.submit(_work, batches))
            while len(inflight) > pack_workers + 1:
                _drain(inflight.popleft())
        while inflight:
            _drain(inflight.popleft())
    if feeder is not None:
        # Flush the staged remainder HERE, not at first device use:
        # the final flush can also trip FusedCapacityExceeded (estimate
        # undershot surfacing only at the tail), and the caller's
        # host-path fallback wraps THIS call.
        feeder.finish()
    if not filt_parts:
        wl = header_umi_size + sum(nt_to_take)
        return (None if feeder is not None
                else np.zeros((0, W.num_lanes(wl)), np.uint32),
                np.zeros(0, bool))
    if feeder is not None:
        return None, np.concatenate(filt_parts)
    return np.concatenate(packed_parts), np.concatenate(filt_parts)


def run(
    files: list[str],
    *,
    word_length: int = 24,
    distance: int = 1,
    log_name: str = "/dev/stderr",
    dir_name: str = ".",
    run_stats: bool = False,
    write_dedup: bool = True,
    write_annotated: bool = False,
    edit: bool = False,
    maximum: bool = False,
    batch_records: int = 1 << 17,
    neighbor_opts: dict | None = None,
    cache_records: bool | None = None,
    profile_dir: str | None = None,
) -> PipelineResult:
    """Deduplicate ``files``; mirrors humid(wordLength, distance, ...)
    (humid.cc:369-409 and CLI defaults humid.cc:413-429).

    ``profile_dir`` (or env HUMID_TPU_PROFILE) captures a jax.profiler
    trace of the whole run, with kernels attributed to pipeline phases.
    """
    if not files:
        from .errors import InputError

        raise InputError("at least one FastQ file required")
    from ._util import tune_malloc

    tune_malloc()  # scoped here, not at package import (ADVICE r2)
    if profile_dir is None:
        profile_dir = os.environ.get("HUMID_TPU_PROFILE")
    if profile_dir:
        import jax.profiler as _prof

        with _prof.trace(profile_dir):
            return run(
                files, word_length=word_length, distance=distance,
                log_name=log_name, dir_name=dir_name, run_stats=run_stats,
                write_dedup=write_dedup, write_annotated=write_annotated,
                edit=edit, maximum=maximum, batch_records=batch_records,
                neighbor_opts=neighbor_opts, cache_records=cache_records,
                profile_dir="",
            )
    log = PhaseLog(log_name)
    log_device(log)
    res = PipelineResult()

    # --- nucleotide budgeting (humid.cc:38-59) ---
    t = log.start("Determing nucleotides to take")
    umi_len = peek_umi_size(files[0])
    header_umi_size, nt_to_take = W.pre_compute(
        umi_len, len(files), word_length
    )
    log.end(t)
    log.write(f"  header: {header_umi_size}")
    for f, k in zip(files, nt_to_take):
        log.write(f"\n  {f}: {k}")
    log.write("\n")

    # --- pass 1: read + pack (readData, humid.cc:70-103) ---
    # Inputs up to 16GB parsed keep their record batches in memory so the
    # output pass skips the second read entirely (the reference always
    # re-reads, humid.cc:203-292).  The cap is deliberate even on
    # large-memory hosts: materializing tens of GB of fresh record
    # arrays costs first-touch page faults and page-cache eviction that
    # measure SLOWER than re-reading a page-cached input at WGS scale
    # (100M: pass-1 5s re-read mode vs 25-54s cached on the dev host).
    cache: list | None = None
    if cache_records is None:
        from ._util import avail_bytes

        cache_records = (
            _input_bytes_estimate(files) < min(1 << 34, avail_bytes() // 3)
        )
    if cache_records and (write_dedup or write_annotated):
        cache = []

    # Span cache: when the record cache does NOT fit (WGS scale) but the
    # inputs are plain (mmap-able) files, collect absolute record spans
    # during pass 1 (8 bytes/record/file — plus 4 for header lengths in
    # annotate mode) so pass 2 copies record bytes from the mmap instead
    # of re-framing the whole input (dedup: selected records only;
    # annotated: raw record + spliced ``:<id>``).
    # HUMID_TPU_SPAN_CACHE=1 forces it (testing), =0 disables.
    span_env = os.environ.get("HUMID_TPU_SPAN_CACHE")
    span_accs = None
    if ((write_dedup or write_annotated) and span_env != "0"
            and (cache is None or span_env == "1")
            and not any(_is_gzip_file(f) for f in files)):
        if span_env == "1":
            cache = None  # force the span path end to end
        from ._util import avail_bytes

        # 8 B/record span, +4 B/record header length in annotate mode —
        # so the 1/32-of-available cap holds for both modes.
        per_rec = 12 if write_annotated else 8
        budget = max(1 << 20,
                     avail_bytes() // (32 * max(len(files), 1)) // per_rec)
        span_accs = [_span_acc_new(budget, with_hdr=write_annotated)
                     for _ in files]

    import time as _time

    wl = header_umi_size + sum(nt_to_take)
    # Fused device-resident route (VERDICT r4 #1): unique counting, the
    # pigeonhole partition sorts, and the in-run Hamming sweeps all run
    # against ONE resident HBM copy of the packed reads, streamed to the
    # device DURING framing — decided before pass 1 so the feeder
    # exists.  Phase-level env overrides (strategy/impl/unique) pin
    # their phase to a specific engine and therefore exclude the fused
    # route; HUMID_TPU_FUSED=1/0 forces it outright (_backend).
    # Overlapped unique counting sorts key runs on the packing pool
    # while the reader streams, leaving only a k-way merge after EOF.
    # It wins when cores outnumber the I/O pipeline (production hosts);
    # on small hosts the extra key materialization contends with
    # framing, so it is opt-in (HUMID_TPU_OVERLAP_UNIQUE=1).
    overlapped = (W.num_lanes(wl) <= 2 and _merge_unique_runs is not None
                  and _encode_pack is not None
                  and os.environ.get("HUMID_TPU_OVERLAP_UNIQUE") == "1")
    feeder = None
    fused_fp = None
    if (not edit and distance >= 1 and not neighbor_opts and not overlapped
            and not os.environ.get("HUMID_TPU_STRATEGY")
            and not os.environ.get("HUMID_TPU_IMPL")
            and not os.environ.get("HUMID_TPU_UNIQUE")):
        # ``not overlapped`` (the EFFECTIVE predicate, not the raw env
        # var): an OVERLAP_UNIQUE=1 opt-in that cannot engage (wide
        # words, missing extension) must not also forfeit the fused
        # route.
        from ._backend import use_fused_pipeline

        if use_fused_pipeline():
            from .ops.fused import DeviceFeeder, fused_fits

            # ~200 B per plain-FastQ record is a deliberate UNDER
            # estimate of record size (over-estimating rows would
            # reserve HBM the run never uses); the feeder grows by
            # doubling if the input runs longer.
            n_est = max(_input_bytes_estimate(files) // 200, 1 << 10)
            if fused_fits(n_est, W.num_lanes(wl)):
                feeder = DeviceFeeder(W.num_lanes(wl), n_est)
    t = log.start("Reading data")
    if feeder is not None:
        from .ops.fused import FusedCapacityExceeded

        try:
            _, filtered = _pass1(files, nt_to_take, header_umi_size,
                                 batch_records, cache,
                                 span_accs=span_accs, feeder=feeder)
        except FusedCapacityExceeded:
            # The pre-run row estimate undershot (extreme compression
            # ratio): drop the fused route and re-read through the
            # host path with FRESH accumulators (the partial cache and
            # span tables saw only a prefix of the input).
            feeder = None
            if cache is not None:
                cache.clear()
            if span_accs is not None:
                span_accs = [_span_acc_new(a["budget"],
                                           a["hdr_parts"] is not None)
                             for a in span_accs]
    if feeder is not None:
        res.total = int(len(filtered))
        res.usable = int((~filtered).sum())
        log.end(t)

        _t_uni = _time.time()
        from .ops.fused import FusedPipeline

        fused_fp = FusedPipeline(
            feeder, res.total, filtered, word_length=wl,
            max_dist=distance, want_inverse=write_annotated,
            want_labels=maximum)
        fused_fp.unique()
        # counts/first/inverse are fetched AFTER the neighbour programs
        # launch (below), keeping this phase to the one k sync.
        counts = first_occ = inv_by_read = None
        uniq = None  # the table stays on the device (sparse decode)
        log.timings.append(
            ("unique counting (fused)", _time.time() - _t_uni))
    elif overlapped:
        # Pass 1 fused with unique counting: per-run sorts ride the
        # packing pool while the reader streams; only the final k-way
        # merge runs after EOF.
        _t_uni = _time.time()
        (res.total, res.usable, uniq, counts, first_occ,
         inv_by_read) = _pass1_overlapped(
            files, nt_to_take, header_umi_size, batch_records, cache,
            want_inverse=write_annotated, span_accs=span_accs)
        log.end(t)
        log.timings.append(
            ("unique counting (overlapped)", _time.time() - _t_uni))
    else:
        packed, filtered = _pass1(files, nt_to_take, header_umi_size,
                                  batch_records, cache,
                                  span_accs=span_accs)
        res.total = int(len(packed))
        res.usable = int((~filtered).sum())
        log.end(t)

        # --- exact duplicate counting (replaces trie leaf counts) ---
        _t_uni = _time.time()
        any_filtered = bool(filtered.any())
        usable_packed = packed[~filtered] if any_filtered else packed
        # The row->unique inverse (and with it the per-read cluster-id
        # vector) is only needed for annotated output; skipping it saves
        # a 100M-row random scatter + gather at WGS scale.
        uniq, counts, first_occ_usable, inverse = unique_words(
            usable_packed, want_inverse=write_annotated)
        # first_occ indexes usable rows; convert to global read indices.
        if any_filtered:
            usable_to_read = np.flatnonzero(~filtered)
            first_occ = (usable_to_read[first_occ_usable]
                         if len(first_occ_usable) else first_occ_usable)
        else:
            usable_to_read = None  # identity mapping
            first_occ = first_occ_usable
        inv_by_read = None
        if write_annotated:
            inv_by_read = np.full(res.total, -1, np.int64)
            if res.total:
                if any_filtered:
                    inv_by_read[usable_to_read] = inverse
                else:
                    inv_by_read[:] = inverse
        log.timings.append(("unique counting", _time.time() - _t_uni))
    res.unique = fused_fp.k if fused_fp is not None else len(uniq)
    res.counts = counts

    # --- neighbour search (humid.cc:113-158) ---
    if edit:
        t = log.start("Calculating neighbours using Levenshtein distance")
    else:
        t = log.start("Calculating neighbours using Hamming distance")
    if fused_fp is not None:
        pa, pb = fused_fp.neighbors()
        counts, first_occ, inv_by_read = fused_fp.tables()
        res.counts = counts
    else:
        nb = dict(neighbor_opts or {})
        # (HUMID_TPU_STRATEGY / HUMID_TPU_IMPL env overrides are
        # honored inside find_neighbor_pairs, so every driver —
        # single-host, sharded, tests — sees them.)
        pa, pb = find_neighbor_pairs(
            uniq, distance,
            metric="edit" if edit else "hamming",
            word_length=word_length, **nb,
        )
    from .ops import neighbors as _nbmod

    res.extra["engine"] = dict(_nbmod.LAST_DECISION)
    indptr, indices = pairs_to_csr(pa, pb, res.unique)
    res.degree = np.diff(indptr)
    log.end(t)

    # --- clustering (humid.cc:167-193, cluster.cc) ---
    if maximum:
        t = log.start("Calculating maximum clusters")
    else:
        t = log.start("Calculating directional clusters")
    if fused_fp is not None and maximum and fused_fp.has_matches:
        # -x on the fused route: component labels come from on-device
        # label propagation over the RESIDENT match masks (plus the
        # host mid/big-run edges, uploaded once) — no pair re-upload;
        # ids/size/maxCount/maxLeaf finalize bit-exactly on host.
        from .cluster.exact import cluster_max_from_components

        cc = fused_fp.device_labels()
        cl = cluster_max_from_components(counts, indptr, indices, cc)
    else:
        cl = cluster_dispatch(counts, indptr, indices, maximum=maximum,
                              pairs=(pa, pb))
    res.clusters = cl.num_clusters
    res.labels = cl.labels
    res.sizes = cl.size
    log.end(t)

    os.makedirs(dir_name, exist_ok=True)

    # Representative read per cluster: the first read (file order) whose
    # word is the cluster's maxLeaf (humid.cc:223-232).
    if cl.num_clusters:
        rep_reads = np.sort(first_occ[cl.max_leaf])
    else:
        rep_reads = np.zeros(0, np.int64)
    res.rep_reads = rep_reads

    # Per-read cluster id (0 for filtered reads; humid.cc:271-278),
    # only materialized for annotated output.  Filtered reads carry
    # inv_by_read == -1, which indexes the appended 0 sentinel.
    cluster_of_read = None
    if write_annotated:
        labels_ext = np.append(cl.labels, np.int64(0))
        cluster_of_read = labels_ext[inv_by_read]
    res.cluster_of_read = cluster_of_read

    # --- pass 2: outputs ---
    span_tables = _span_tables_from_accs(span_accs, res.total)
    if write_dedup:
        t = log.start("Writing filtered results")
        if span_tables is not None:
            _write_selected_spans(files, dir_name, "dedup", rep_reads,
                                  span_tables)
        else:
            _write_selected(files, dir_name, "dedup", rep_reads,
                            batch_records, cache)
        log.end(t)
    if write_annotated:
        t = log.start("Writing annotated results")
        if span_tables is not None and all(
                tb[2] is not None for tb in span_tables):
            _write_annotated_spans(
                files, make_file_names(list(files), dir_name, "annotated"),
                cluster_of_read, span_tables)
        else:
            _write_annotated(files, dir_name, cluster_of_read,
                             batch_records, cache)
        log.end(t)

    if run_stats:
        t = log.start("Calculating count and neighbour stats")
        log.end(t)
        write_statistics(
            counts=res.counts,
            degrees=res.degree,
            sizes=res.sizes,
            total=res.total,
            usable=res.usable,
            unique=res.unique,
            num_clusters=res.clusters,
            dir_name=dir_name,
        )

    res.extra["timings"] = dict(log.timings)
    log.close()
    return res


def _pipelined_write(source, names, build_one,
                     build_workers: int | None = None):
    """Drive an output pass with builds overlapped against writes.

    ``build_one(batches) -> list[np.ndarray]`` (one record buffer per
    file) runs on a thread pool (record assembly is GIL-releasing native
    gather); gzip outputs are also compressed on the pool, each batch
    becoming an independent gzip member (valid multi-member stream with
    byte-identical decompressed content).  The main thread writes
    completed payloads in order; bounded in-flight futures keep memory
    proportional to the pool size.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    import re

    from .io.writer import compress_member

    # Compression is decided by the FINAL name: a multi-host part file
    # ("<final>.partNNNNN") hides the .gz suffix from plain inference.
    writers = [
        FastqWriter(n, compress=re.sub(r"\.part\d{5}$", "", n)
                    .endswith(".gz"))
        for n in names
    ]
    if build_workers is None:
        # Gzip outputs spend their time in member compression — give
        # them the whole pool; plain outputs are gather-bound.
        build_workers = 4 if any(w.is_gz for w in writers) else 2

    def _build_and_pack(item):
        outs = build_one(item)
        return [
            compress_member(o, w.compression)
            if w.is_gz and len(o) else o
            for w, o in zip(writers, outs)
        ]

    def _flush(fut):
        for w, out in zip(writers, fut.result()):
            w.write_payload(out)

    try:
        with ThreadPoolExecutor(max_workers=build_workers) as ex:
            inflight: deque = deque()
            for batches in source:
                inflight.append(ex.submit(_build_and_pack, batches))
                while len(inflight) > build_workers + 1:
                    _flush(inflight.popleft())
            while inflight:
                _flush(inflight.popleft())
    finally:
        for w in writers:
            w.close()


def _write_selected(files, dir_name, suffix, selected, batch_records,
                    cache=None):
    """Second pass: write only reads whose global index is in ``selected``
    (sorted)."""
    from .io import build_records

    names = make_file_names(list(files), dir_name, suffix)
    source = cache if cache is not None else read_tuples(
        files, batch_records)

    # Selection state advances per batch, so the plan (which records of
    # this batch are selected) is computed on the main thread during
    # submission; only the record assembly runs on the pool.
    state = {"base": 0, "ptr": 0}

    def _planned_source():
        for batches in source:
            n = batches[0].n
            base, ptr = state["base"], state["ptr"]
            end = int(np.searchsorted(selected, base + n, side="left"))
            local = (selected[ptr:end] - base).astype(np.int64)
            state["base"] = base + n
            state["ptr"] = end
            yield (batches, local)

    def _build_planned(item):
        batches, local = item
        return [build_records(b, local) for b in batches]

    _pipelined_write(_planned_source(), names, _build_planned)


def _write_selected_spans(files, dir_name, suffix, selected, span_tables,
                          chunk: int = 1 << 19):
    """Second pass via cached record spans (reference-named outputs)."""
    names = make_file_names(list(files), dir_name, suffix)
    _write_selected_spans_to(files, names, selected, span_tables,
                             chunk=chunk)


def _span_tables_from_accs(span_accs, expected_entries: int):
    """[(starts_abs, end_sentinel, hdr_lens-or-None)] per file when
    every accumulator is valid and covers exactly ``expected_entries``
    records — None otherwise (the caller falls back to the re-reading
    writer)."""
    if span_accs is None or not all(
        a["ok"] and a["entries"] == expected_entries for a in span_accs
    ):
        return None
    return [
        (np.concatenate(a["parts"]) if a["parts"]
         else np.zeros(0, np.int64),
         a["base"],
         None if a["hdr_parts"] is None else
         (np.concatenate(a["hdr_parts"]) if a["hdr_parts"]
          else np.zeros(0, np.int32)))
        for a in span_accs
    ]


def _write_selected_spans_to(files, names, selected, span_tables,
                             chunk: int = 1 << 19):
    """Write the SELECTED records to ``names`` via cached record spans:
    mmap each (plain) input and concatenate only the selected records'
    raw bytes — no re-framing scan of the input.  Raw spans equal the
    canonical 4-line records because span collection verified LF-only
    line endings (``_span_batch_part``); a final record missing its
    trailing newline gets one appended, matching build_records."""
    import mmap as _mmap

    from .io.writer import _build_output
    fulls = []
    handles = []
    try:
        for f in files:
            fh = open(f, "rb")
            try:
                mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
            except ValueError:  # zero-byte file: nothing to select
                fh.close()
                fulls.append(np.zeros(0, np.uint8))
                continue
            handles.append((fh, mm))
            fulls.append(np.frombuffer(mm, np.uint8))

        def source():
            for lo in range(0, len(selected), chunk):
                yield selected[lo:lo + chunk]

        def build_one(sel):
            outs = []
            for full, (starts, total, _hdr) in zip(fulls, span_tables):
                s = starts[sel]
                e = np.empty(len(sel), np.int64)
                nxt = sel + 1
                inside = nxt < len(starts)
                e[inside] = starts[nxt[inside]]
                e[~inside] = total
                # A final record without a trailing newline spans one
                # byte past EOF (its raw length was counted with the
                # synthetic newline); clamp and emit the newline.
                nl_after = e > len(full)
                if nl_after.any():
                    np.minimum(e, len(full), out=e)
                outs.append(_build_output(full, s, e - s, nl_after))
            return outs

        _pipelined_write(source(), names, build_one)
    finally:
        fulls.clear()  # drop the numpy views of the maps first
        for fh, mm in handles:
            try:
                mm.close()
            except BufferError:  # a view outlived us; GC will close it
                pass
            fh.close()


def _write_annotated_spans(files, names, cluster_of_read, span_tables,
                           chunk: int = 1 << 19):
    """Annotated pass via cached record spans + header lengths: splice
    ``:<cluster_id>`` after each record's name line directly from an
    mmap of the (plain) input — no pass-2 re-framing (VERDICT r2 #8).

    Per record three segments are emitted: the name line (no newline),
    the rendered ``:<id>``, and the raw remainder of the record starting
    at the name's newline — raw bytes equal the canonical record because
    span collection verified LF-only endings (``_span_batch_part``)."""
    import mmap as _mmap

    from .io.writer import _ann_buffer, _build_output

    n = len(cluster_of_read)
    fulls = []
    handles = []
    try:
        for f in files:
            fh = open(f, "rb")
            try:
                mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
            except ValueError:
                fh.close()
                fulls.append(np.zeros(0, np.uint8))
                continue
            handles.append((fh, mm))
            fulls.append(np.frombuffer(mm, np.uint8))

        def source():
            for lo in range(0, n, chunk):
                yield lo, min(n, lo + chunk)

        def build_one(rng):
            lo, hi = rng
            k = hi - lo
            ann_buf, ann_s, ann_l = _ann_buffer(cluster_of_read[lo:hi])
            outs = []
            for full, (starts, total, hdr) in zip(fulls, span_tables):
                s = starts[lo:hi]
                e = np.empty(k, np.int64)
                e[:-1] = starts[lo + 1:hi] if k > 1 else e[:0]
                e[-1] = starts[hi] if hi < len(starts) else total
                h = hdr[lo:hi].astype(np.int64)
                # The chunk's records are contiguous: copy their raw
                # byte range once, then gather segments relative to it.
                base = int(s[0]) if k else 0
                end = int(e[-1]) if k else 0
                nl_missing = end > len(full)  # unterminated final record
                if nl_missing:
                    end = len(full)
                src = np.concatenate([full[base:end], ann_buf])
                seg_start = np.empty((k, 3), np.int64)
                seg_len = np.empty((k, 3), np.int64)
                seg_start[:, 0] = s - base
                seg_len[:, 0] = h
                seg_start[:, 1] = (end - base) + ann_s
                seg_len[:, 1] = ann_l
                seg_start[:, 2] = s - base + h
                seg_len[:, 2] = e - s - h
                nl_after = np.zeros((k, 3), bool)
                if nl_missing:
                    seg_len[-1, 2] -= 1  # the counted synthetic newline
                    nl_after[-1, 2] = True
                outs.append(_build_output(src, seg_start.ravel(),
                                          seg_len.ravel(),
                                          nl_after.ravel()))
            return outs

        _pipelined_write(source(), names, build_one)
    finally:
        fulls.clear()
        for fh, mm in handles:
            try:
                mm.close()
            except BufferError:
                pass
            fh.close()


def _write_annotated(files, dir_name, cluster_of_read, batch_records,
                     cache=None):
    """Second pass: every read annotated with ``:<cluster_id>``
    (humid.cc:251-292)."""
    from .io import build_records_annotated

    names = make_file_names(list(files), dir_name, "annotated")
    source = cache if cache is not None else read_tuples(
        files, batch_records)

    state = {"base": 0}

    def _planned_source():
        for batches in source:
            n = batches[0].n
            ids = cluster_of_read[state["base"]:state["base"] + n]
            state["base"] += n
            yield (batches, ids)

    def _build_planned(item):
        batches, ids = item
        return [build_records_annotated(b, ids) for b in batches]

    _pipelined_write(_planned_source(), names, _build_planned)
