"""Distributed (multi-host) pipeline driver for WGS-scale runs.

Composes the single-host building blocks into the full data-parallel
flow of BASELINE.json's north star:

  1. every host ingests its record range of every input file (lockstep,
     so tuples stay aligned) and packs fingerprints locally;
  2. per-host unique tables merge into the global table over DCN
     (humid_tpu.parallel.multihost) — counts summed, globally smallest
     first-occurrence kept, so representative selection stays byte-exact;
  3. the neighbour search + clustering run on the global unique table:
     on every host for the host-local outputs (the table is ~100x
     smaller than the input), sharded over each host's local chip mesh
     (humid_tpu.parallel.neighbors / labelprop);
  4. every host writes the output records of its own range.

Single-process testing injects ``all_gather`` (see tests/test_multihost
and tests/test_distributed_pipeline); under a real multi-host job call
``init_distributed()`` first and every process runs ``run_sharded``
with its own ``process_id``/``num_processes``.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from .. import words as W
from ..io import make_file_names, read_tuples
from ..ops import find_neighbor_pairs, pairs_to_csr
from ..ops.unique import unique_words
from ..io import skip_to_record
from ..pipeline import _batch_words, peek_umi_size
from .multihost import host_record_range

#: auto-gate for the host-sharded cluster phase: size floor AND host
#: floor.  The per-host WALK is measured at ~1/P of the replicated walk
#: (BASELINE.md round 5), but the shared terms (components + ownership
#: + cluster-row gather + seed-rank merge, all O(u+E+k)) rival the walk
#: itself on this 4-core/gloo-localhost box, so every measurable config
#: here LOSES (0.75 s vs 0.21 s at 1.79M uniques, 2 procs) and the
#: auto gate requires a regime this box cannot reach: >=4 hosts over
#: real DCN, where walk/P shrinks and the gather costs ~ms.  That gate
#: is arithmetic, not measurement — the measured trend and the loss
#: decomposition are in BASELINE.md; HUMID_TPU_CLUSTER_SHARDED=1/0
#: overrides both ways.
_SHARDED_CLUSTER_MIN_U = 1 << 22
_SHARDED_CLUSTER_MIN_HOSTS = 4


def _count_records_one(path: str) -> int:
    """Record count of one FastQ (any compression): line count // 4 (the
    framer's own rule — newline phase mod 4, with an unterminated final
    line closing its record ONLY when it has non-whitespace content; the
    framer drops a whitespace-only trailing segment, so a whitespace
    final line must not mint a phantom record)."""
    from ..io.reader import _open_stream, iter_chunk_newline_counts

    stream = _open_stream(path)
    nl = 0
    tail_nonws = False  # does the unterminated final line have content?
    try:
        for data, n in iter_chunk_newline_counts(stream):
            nl += n
            idx = data.rfind(b"\n")
            if idx < 0:
                tail_nonws = tail_nonws or bool(data.strip())
            else:
                tail_nonws = bool(data[idx + 1:].strip())
    finally:
        stream.close()
    lines = nl + tail_nonws
    return lines // 4


_COUNT_CHUNK = 32 * 1024 * 1024


def _scan_plain_counts(path: str):
    """Plain (non-gzip) file: (record count, per-chunk newline counts).
    None for gzip inputs.  The chunk table lets ``_offset_from_table``
    find any record's byte offset later by reading ONE chunk."""
    from ..io.reader import is_gzip_file, iter_chunk_newline_counts

    if is_gzip_file(path):
        return None
    counts = []
    tail_nonws = False  # mirror _count_records_one's final-line rule
    with open(path, "rb") as f:
        for data, n in iter_chunk_newline_counts(f, _COUNT_CHUNK):
            counts.append(n)
            idx = data.rfind(b"\n")
            if idx < 0:
                tail_nonws = tail_nonws or bool(data.strip())
            else:
                tail_nonws = bool(data[idx + 1:].strip())
    table = np.asarray(counts, np.int64)
    lines = int(table.sum()) + tail_nonws
    return lines // 4, table


def _offset_from_table(path: str, k: int, chunk_counts: np.ndarray):
    """Byte offset of record ``k`` using the count scan's chunk table:
    locate the chunk holding the 4k-th newline, re-read just that chunk
    (page-cached from the count scan), flatnonzero within it."""
    if k <= 0:
        return 0
    need = 4 * k
    cum = np.cumsum(chunk_counts)
    if len(cum) == 0 or need > int(cum[-1]):
        return None
    ci = int(np.searchsorted(cum, need))
    prev = int(cum[ci - 1]) if ci else 0
    with open(path, "rb") as f:
        f.seek(ci * _COUNT_CHUNK)
        buf = np.frombuffer(f.read(_COUNT_CHUNK), np.uint8)
    pos = int(np.flatnonzero(buf == ord("\n"))[need - prev - 1])
    return ci * _COUNT_CHUNK + pos + 1


def count_records_with_tables(files):
    """(lockstep tuple count, per-file chunk newline tables or None).

    The tuple count is the MIN over files (the lockstep reader stops at
    the shortest file, fastq.cc:41-43).  For plain files the same scan
    also yields the chunk tables that make record->offset lookups O(one
    chunk) instead of a second partial scan."""
    files = [files] if isinstance(files, str) else list(files)

    def one(f):
        d = _scan_plain_counts(f)
        if d is None:
            return _count_records_one(f), None
        return d

    if len(files) == 1:
        results = [one(files[0])]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(files)) as pool:
            results = list(pool.map(one, files))
    total = min(n for n, _ in results)
    tables = [t for _, t in results]
    if any(t is None for t in tables):
        tables = None
    return total, tables


def count_records(files) -> int:
    """Number of lockstep record-tuples across ``files`` — a raw newline
    scan per file (files in parallel), not a framing pass."""
    return count_records_with_tables(files)[0]


def _spill_gz_range(path: str, lo: int, hi: int, spill_path: str):
    """Stream-decompress a gzip FastQ ONCE, writing the bytes of records
    [lo, hi) into a sparse plain file at their STREAM-ABSOLUTE offsets,
    and stop decompressing right after record ``hi`` — hosts early in
    the range do proportionally less inflate work, and no host ever
    frames, packs, or (pass 2) re-reads bytes outside its own range.

    The sparse layout (seek past the skipped prefix) preserves absolute
    byte offsets, so the chunk-table/offset/span machinery built for
    plain inputs applies to the spill unchanged.  Returns
    (start_offset, end_offset) of the range in stream coordinates
    (end == the spill's apparent size).

    This is the multi-host gzip strategy the reference sidesteps by
    being single-process (it links isa-l for fast sequential inflate,
    /root/reference/docs/install.rst:32-43); gzip streams are not
    random-access, so range-proportional DECOMPRESSION would need an
    index — range-proportional everything-else is achievable and is
    what this provides."""
    from ..io.reader import _open_stream, iter_chunk_newline_counts

    need_lo, need_hi = 4 * lo, 4 * hi
    seen = 0
    base = 0
    started = lo == 0
    start_off = 0 if started else None
    end_off = None
    stream = _open_stream(path)
    out = open(spill_path, "wb")
    try:
        for data, n in iter_chunk_newline_counts(stream):
            s_in = 0
            if not started:
                if seen + n >= need_lo:
                    buf = np.frombuffer(data, np.uint8)
                    pos = int(np.flatnonzero(buf == 10)[need_lo - seen - 1])
                    start_off = base + pos + 1
                    s_in = pos + 1
                    started = True
                    out.seek(start_off)
                else:
                    seen += n
                    base += len(data)
                    continue
            if seen + n >= need_hi:
                buf = np.frombuffer(data, np.uint8)
                pos = int(np.flatnonzero(buf == 10)[need_hi - seen - 1])
                end_off = base + pos + 1
                out.write(data[s_in:pos + 1])
                break
            out.write(data[s_in:])
            seen += n
            base += len(data)
        else:
            # EOF before the hi-th record boundary: unterminated final
            # record (or fewer records than hi) — the range ends at EOF.
            end_off = base
            if start_off is None:
                start_off = base
        # Apparent size == range end even when nothing was written
        # (empty range) — keeps mmap/slice consumers uniform.
        out.truncate(end_off)
    finally:
        out.close()
        stream.close()
    return start_off, end_off


def spill_gz_ranges(files, lo: int, hi: int):
    """Spill every gzip member of ``files`` to a per-host scratch dir
    (plain files pass through).  Returns (files_local, start_offsets,
    spill_dir-or-None); offsets for plain files come from the usual raw
    newline scan.  Caller owns cleanup of ``spill_dir``."""
    import tempfile

    if not any(_gz(f) for f in files):
        return list(files), None, None
    spill_dir = tempfile.mkdtemp(prefix="humid_tpu_gzspill_")
    files_local = list(files)
    offs: list[int | None] = []
    try:
        for i, f in enumerate(files):
            if _gz(f):
                sp = os.path.join(
                    spill_dir, f"spill{i:03d}_{os.path.basename(f)}.plain")
                so, _ = _spill_gz_range(f, lo, hi, sp)
                files_local[i] = sp
                offs.append(so)
            else:
                offs.append(skip_to_record(f, lo))
        if any(o is None for o in offs):
            # A plain file with fewer than lo records (can't happen when
            # hi <= lockstep total, but stay safe): abandon the spill.
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)
            return list(files), None, None
        return files_local, offs, spill_dir
    except BaseException:
        import shutil

        shutil.rmtree(spill_dir, ignore_errors=True)
        raise


def _gz(path: str) -> bool:
    from ..io.reader import is_gzip_file

    return is_gzip_file(path)


def range_start_offsets(files, lo: int):
    """Byte offsets of record ``lo`` in every file (None when any file is
    gzip or shorter than ``lo`` — callers then frame from the start).
    Lets each host skip the records before its range with a raw
    newline-count scan instead of framing them (~3x cheaper), and skip
    the framing of the range entirely on the second (output) pass."""
    if lo <= 0:
        return None
    offs = [skip_to_record(f, lo) for f in files]
    if any(o is None for o in offs):
        return None
    return offs


def pack_host_range(files, lo: int, hi: int, *, word_length: int = 24,
                    start_offsets=None, span_accs=None):
    """Pack fingerprints for record-tuples [lo, hi) of every file.

    Returns (packed [n, W], filtered [n]); indices are LOCAL (add ``lo``
    for global read indices).  ``start_offsets`` (from
    :func:`range_start_offsets`) starts framing at record ``lo``
    directly.  ``span_accs`` (one per file, bases preset to record lo's
    byte offset) collect the range's absolute record spans for the
    span-based dedup part writer.
    """
    from ..pipeline import _span_batch_part, _span_stitch

    umi_len = peek_umi_size(files[0])
    header_umi_size, nt_to_take = W.pre_compute(
        umi_len, len(files), word_length
    )
    shift = lo if start_offsets is not None else 0
    packed_parts, filt_parts = [], []
    base = 0
    for batches in read_tuples(files, start_offsets=start_offsets):
        n = batches[0].n
        s = max((lo - shift) - base, 0)
        e = min((hi - shift) - base, n)
        base += n
        if e <= s:
            if base >= hi - shift:
                break
            continue
        sub = [b.slice_records(s, e) for b in batches]
        if span_accs is not None:
            for b, acc in zip(sub, span_accs):
                _span_stitch(
                    _span_batch_part(b, acc["hdr_parts"] is not None),
                    acc)
        packed, filtered = _batch_words(sub, nt_to_take, header_umi_size)
        packed_parts.append(packed)
        filt_parts.append(filtered)
        if base >= hi - shift:
            break
    if not packed_parts:
        wl = header_umi_size + sum(nt_to_take)
        return (np.zeros((0, W.num_lanes(wl)), np.uint32),
                np.zeros(0, bool))
    return np.concatenate(packed_parts), np.concatenate(filt_parts)


def _compute_sharded(
    files,
    *,
    word_length: int = 24,
    distance: int = 1,
    edit: bool = False,
    maximum: bool = False,
    total_records: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    all_gather=None,
    neighbor_opts: dict | None = None,
    collect_spans: bool = False,
    collect_hdr: bool = False,
    want_labels: bool = True,
):
    """Shared compute stage of the sharded pipeline.  Returns a dict with
    the global clustering plus this host's local arrays (for the output
    stage) and per-phase wall timings (the scaling-efficiency report's
    raw material, VERDICT r3 #10)."""
    import time as _time

    from ..pipeline import _is_gzip_file, _span_acc_new

    timings: dict[str, float] = {}
    _t0 = _time.perf_counter()

    def _mark(phase: str) -> None:
        nonlocal _t0
        now = _time.perf_counter()
        timings[phase] = timings.get(phase, 0.0) + (now - _t0)
        _t0 = now

    n_proc = (num_processes if num_processes is not None
              else jax.process_count())
    tables = None
    if total_records is None:
        total_records, tables = count_records_with_tables(files)
    lo, hi = host_record_range(total_records, process_id, n_proc)
    files_local = list(files)
    spill_dir = None
    if (n_proc > 1 and any(_is_gzip_file(f) for f in files)
            and os.environ.get("HUMID_TPU_GZ_SPILL", "1") != "0"):
        # Gzip at multi-host scale: spill each gz input's [lo, hi) byte
        # range to a local sparse plain file in ONE streaming inflate
        # that stops at the range end; framing, packing, spans, and the
        # output pass then run range-proportionally on the spill.
        files_local, start_offsets, spill_dir = spill_gz_ranges(
            files, lo, hi)
        if jax.process_count() == n_proc:
            # Spill durations are range-proportional (the LAST host
            # inflates the whole stream), so hosts leave this point
            # minutes apart at WGS scale — past the ~30 s gloo context
            # init timeout of the first DCN gather.  Absorb the skew
            # on the coordination service, which tolerates hours.
            from .multihost import coordination_barrier

            coordination_barrier("gz_spill")
    elif tables is not None and lo > 0:
        offs = [_offset_from_table(f, lo, t)
                for f, t in zip(files, tables)]
        start_offsets = (offs if all(o is not None for o in offs)
                         else range_start_offsets(files, lo))
    else:
        start_offsets = range_start_offsets(files, lo)
    span_accs = None
    if (collect_spans
            and os.environ.get("HUMID_TPU_SPAN_CACHE") != "0"
            and (start_offsets is not None or lo == 0)
            and not any(_is_gzip_file(f) for f in files_local)):
        from .._util import avail_bytes

        budget = max(1 << 20,
                     avail_bytes() // (32 * max(len(files), 1)) // 8)
        span_accs = [_span_acc_new(budget, with_hdr=collect_hdr)
                     for _ in files]
        if start_offsets is not None:
            for acc, off in zip(span_accs, start_offsets):
                acc["base"] = off
    _mark("range_setup")
    packed, filtered = pack_host_range(
        files_local, lo, hi, word_length=word_length,
        start_offsets=start_offsets, span_accs=span_accs,
    )
    _mark("pack")
    usable = packed[~filtered]
    local_to_read = np.flatnonzero(~filtered) + lo
    uniq_l, counts_l, first_l, _ = unique_words(usable,
                                                want_inverse=False)
    first_global = (local_to_read[first_l] if len(first_l)
                    else first_l)
    _mark("unique_local")

    if all_gather is None and n_proc == 1:
        uniq, counts, first_occ = uniq_l, counts_l, first_global
    else:
        if all_gather is None and jax.process_count() != n_proc:
            raise RuntimeError(
                f"num_processes={n_proc} but jax.process_count()="
                f"{jax.process_count()} and no all_gather was injected; "
                "initialize jax.distributed (CLI: --coordinator) or the "
                "merge would silently use only this host's table")
        from .multihost import merge_unique_tables

        uniq, counts, first_occ = merge_unique_tables(
            uniq_l, counts_l, first_global, all_gather=all_gather
        )
    _mark("unique_merge")

    nb = dict(neighbor_opts or {})
    p = process_id if process_id is not None else (
        jax.process_index() if n_proc > 1 else 0)
    if n_proc > 1 and (all_gather is not None
                       or jax.process_count() == n_proc):
        # Host-sharded neighbour phase (VERDICT r2 #3): this host
        # computes only the ~1/n_proc slice of candidate work it owns,
        # then the partial edge lists merge over DCN — per-host
        # neighbour work is O(U/P) instead of every host redundantly
        # searching the full table.
        nb.setdefault("shard", (p, n_proc))
        if edit and "join_cap" not in nb:
            # The shifted-segment join_cap defaults from THIS host's
            # free memory — but the JoinCapExceeded fallback switches
            # the candidate-partitioning scheme (shifted joins -> dense
            # stripes), so hosts MUST take it together or the union of
            # their differently-partitioned contributions misses pairs.
            # Agree on the minimum cap over DCN (the pre-counted join
            # sizes are already shard-independent).
            from .multihost import default_all_gather
            from .._util import avail_bytes

            gather = (all_gather if all_gather is not None
                      else default_all_gather)
            mine = max(1 << 26, avail_bytes() // 4 // 16)
            (caps,) = gather([np.asarray([mine], np.int64)])
            nb["join_cap"] = min(
                int(np.asarray(c).ravel()[0]) for c in caps)
        if (not edit and "strategy" not in nb
                and not os.environ.get("HUMID_TPU_STRATEGY")):
            # All hosts must run the same engine; adopt host 0's
            # calibrated decision (VERDICT r3 #5) instead of pinning
            # the host engine.  Env/explicit strategy wins (assumed
            # identical across hosts, as documented).
            from .multihost import broadcast_engine_choice

            nb["strategy"] = broadcast_engine_choice(
                all_gather=all_gather)
        pa_l, pb_l = find_neighbor_pairs(
            uniq, distance, metric="edit" if edit else "hamming",
            word_length=word_length, **nb
        )
        from .multihost import merge_edge_lists

        pa, pb = merge_edge_lists(pa_l, pb_l, all_gather=all_gather)
    else:
        pa, pb = find_neighbor_pairs(
            uniq, distance, metric="edit" if edit else "hamming",
            word_length=word_length, **nb
        )
    _mark("neighbors")
    indptr, indices = pairs_to_csr(pa, pb, len(uniq))
    # Distributed cluster phase (VERDICT r4 #3): each host walks only
    # the connected components it owns (salted hash of the component
    # min node), and per-cluster rows + per-node seeds merge over DCN
    # with the seed-rank renumber — ~1/P per-host clustering work
    # instead of every host redundantly walking the full table.  The
    # gather pays fixed DCN latency, so small tables (where the
    # replicated walk costs milliseconds) keep the replicated path;
    # HUMID_TPU_CLUSTER_SHARDED=1/0 forces.
    env_sh = os.environ.get("HUMID_TPU_CLUSTER_SHARDED")
    use_sharded_cl = (env_sh == "1" or (
        env_sh != "0" and len(uniq) >= _SHARDED_CLUSTER_MIN_U
        and n_proc >= _SHARDED_CLUSTER_MIN_HOSTS))
    if use_sharded_cl and n_proc > 1 and (
            all_gather is not None or jax.process_count() == n_proc):
        from .cluster import cluster_sharded
        from .multihost import default_all_gather

        cl = cluster_sharded(
            counts, indptr, indices, pa, pb, maximum=maximum,
            shard=(p, n_proc), want_labels=want_labels,
            all_gather=(all_gather if all_gather is not None
                        else default_all_gather))
    else:
        from ..pipeline import cluster_dispatch

        cl = cluster_dispatch(counts, indptr, indices, maximum=maximum,
                              pairs=(pa, pb))
    _mark("cluster")
    from ..pipeline import _span_tables_from_accs

    span_tables = _span_tables_from_accs(span_accs, hi - lo)
    return dict(
        cl=cl, counts=counts, first_occ=first_occ, uniq=uniq,
        indptr=indptr, lo=lo, hi=hi, filtered=filtered,
        usable=usable, total_records=total_records, n_proc=n_proc,
        start_offsets=start_offsets, span_tables=span_tables,
        files_local=files_local, spill_dir=spill_dir, timings=timings,
    )


def run_sharded(
    files,
    *,
    word_length: int = 24,
    distance: int = 1,
    edit: bool = False,
    maximum: bool = False,
    total_records: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    all_gather=None,
    neighbor_opts: dict | None = None,
):
    """Host-sharded dedup: this host packs its record range, merges
    unique tables globally, and computes the global clustering.

    Returns (labels [U], counts [U], first_occ [U] global read indices,
    uniq [U, W]) — identical on every host, and identical to a
    single-host :func:`humid_tpu.ops.unique.unique_words` +
    clustering run over the whole input.
    """
    st = _compute_sharded(
        files, word_length=word_length, distance=distance, edit=edit,
        maximum=maximum, total_records=total_records,
        process_id=process_id, num_processes=num_processes,
        all_gather=all_gather, neighbor_opts=neighbor_opts,
    )
    if st["spill_dir"]:
        import shutil

        shutil.rmtree(st["spill_dir"], ignore_errors=True)
    return st["cl"], st["counts"], st["first_occ"], st["uniq"]


def _part_names(names, process_id: int):
    return [f"{n}.part{process_id:05d}" for n in names]


def _part_writers(names):
    """Writers for per-host part files: gzip is decided by the FINAL
    name (the ``.partNNNNN`` suffix hides the ``.gz``)."""
    from ..io import FastqWriter

    return [
        FastqWriter(n, compress=n.rsplit(".part", 1)[0].endswith(".gz"))
        for n in names
    ]


def _write_range_selected(files, names, selected_local, lo, hi,
                          batch_records, start_offsets=None):
    """Write the records of [lo, hi) whose LOCAL index is in
    ``selected_local`` (sorted) to ``names`` (one writer per file)."""
    writers = _part_writers(names)
    shift = lo if start_offsets is not None else 0
    base = 0
    ptr = 0
    try:
        for batches in read_tuples(files, batch_records,
                                   start_offsets=start_offsets):
            n = batches[0].n
            s = max((lo - shift) - base, 0)
            e = min((hi - shift) - base, n)
            if e > s:
                sub = [b.slice_records(s, e) for b in batches]
                local_off = base + s - (lo - shift)
                end = int(np.searchsorted(selected_local,
                                          local_off + (e - s), "left"))
                loc = (selected_local[ptr:end] - local_off).astype(
                    np.int64)
                for b, w in zip(sub, writers):
                    w.write_records(b, loc)
                ptr = end
            base += n
            if base >= hi - shift:
                break
    finally:
        for w in writers:
            w.close()


def _write_range_annotated(files, names, cluster_of_local, lo, hi,
                           batch_records, start_offsets=None):
    """Write ALL records of [lo, hi) with ``:<cluster_id>`` appended."""
    writers = _part_writers(names)
    shift = lo if start_offsets is not None else 0
    base = 0
    try:
        for batches in read_tuples(files, batch_records,
                                   start_offsets=start_offsets):
            n = batches[0].n
            s = max((lo - shift) - base, 0)
            e = min((hi - shift) - base, n)
            if e > s:
                sub = [b.slice_records(s, e) for b in batches]
                lo_l = base + s - (lo - shift)
                ids = cluster_of_local[lo_l:lo_l + (e - s)]
                for b, w in zip(sub, writers):
                    w.write_records_annotated(b, ids)
            base += n
            if base >= hi - shift:
                break
    finally:
        for w in writers:
            w.close()


def finalize_outputs(names, num_processes: int) -> None:
    """Concatenate per-host part files into the final outputs (called on
    host 0 after the output barrier).  Plain parts concatenate to the
    byte-identical single-host stream; gzip parts form a valid
    multi-member gzip whose decompressed content is identical."""
    import shutil

    for name in names:
        with open(name, "wb") as out:
            for p in range(num_processes):
                part = f"{name}.part{p:05d}"
                with open(part, "rb") as src:
                    shutil.copyfileobj(src, out, 1 << 24)
                os.remove(part)


#: Stable gather order of the per-host phase timings (the scaling
#: report's wire format — every host must agree on it).
_SCALING_PHASES = ("range_setup", "pack", "unique_local", "unique_merge",
                   "neighbors", "cluster", "write_dedup",
                   "write_annotated")

#: Most recent scaling report computed by run_distributed on this host
#: (diagnostics/tests; host 0's copy is the authoritative one).
LAST_SCALING_REPORT: dict = {}


def scaling_report(per_host: "np.ndarray", n_proc: int) -> dict:
    """Scaling-efficiency summary from per-host per-phase wall timings.

    ``per_host``: [n_proc, len(_SCALING_PHASES)] seconds.  For each
    phase the critical path is the slowest host (hosts run phases in
    lockstep around the DCN merges), so

      wall          = sum over phases of max-over-hosts
      total_work    = sum of all entries
      efficiency    = total_work / (n_proc * wall)

    — 1.0 means perfectly balanced hosts (the north star asks >= 0.8 at
    4 hosts); imbalance or replicated work (e.g. the global cluster
    phase every host repeats) drags it down.  Per-phase efficiencies
    localize the drag."""
    per_host = np.asarray(per_host, np.float64)
    n_proc = int(n_proc)
    phase_max = per_host.max(axis=0)
    phase_sum = per_host.sum(axis=0)
    wall = float(phase_max.sum())
    total_work = float(phase_sum.sum())
    phases = {}
    for i, name in enumerate(_SCALING_PHASES):
        if phase_max[i] <= 0:
            continue
        phases[name] = {
            "max_s": round(float(phase_max[i]), 4),
            "sum_s": round(float(phase_sum[i]), 4),
            "efficiency": round(
                float(phase_sum[i]) / (n_proc * float(phase_max[i])), 4),
        }
    return {
        "n_hosts": n_proc,
        "wall_s": round(wall, 4),
        "total_work_s": round(total_work, 4),
        "efficiency": round(total_work / (n_proc * wall), 4)
        if wall > 0 else 1.0,
        "phases": phases,
        "per_host_s": [[round(float(v), 4) for v in row]
                       for row in per_host],
    }


def run_distributed(
    files,
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
    total_records: int | None = None,
    process_id: int | None = None,
    num_processes: int | None = None,
    all_gather=None,
    barrier=None,
    finalize: bool = True,
    batch_records: int = 1 << 17,
    neighbor_opts: dict | None = None,
):
    """Full multi-host pipeline: sharded compute + sharded output.

    Every host packs and clusters as :func:`run_sharded`, then writes
    the dedup/annotated records of its OWN record range to per-host part
    files; host 0 writes the statistics files, and (after a cross-host
    barrier) concatenates the parts into the reference-named outputs —
    the same files a single-host :func:`humid_tpu.pipeline.run` produces
    (humid.cc:203-292 output contract).

    ``all_gather``/``barrier`` are injectable for in-process multi-host
    simulation; under a real ``jax.distributed`` job leave them None.
    """
    from .._util import tune_malloc
    from ..phaselog import PhaseLog
    from ..pipeline import log_device
    from ..stats import write_statistics
    from .multihost import default_barrier, global_unique_index

    tune_malloc()  # scoped here, not at package import (ADVICE r2)
    p = process_id if process_id is not None else jax.process_index()
    log = PhaseLog(log_name if p == 0 else os.devnull)
    log_device(log)

    t = log.start("Reading data")
    st = _compute_sharded(
        files, word_length=word_length, distance=distance, edit=edit,
        maximum=maximum, total_records=total_records, process_id=p,
        num_processes=num_processes, all_gather=all_gather,
        neighbor_opts=neighbor_opts,
        collect_spans=write_dedup or write_annotated,
        collect_hdr=write_annotated,
        # Per-node labels only feed the annotated writer; dedup-only
        # runs skip their gather + merge (rep_reads/stats need only the
        # per-cluster rows).
        want_labels=write_annotated,
    )
    log.end(t)
    cl, counts, first_occ = st["cl"], st["counts"], st["first_occ"]
    lo, hi, n_proc = st["lo"], st["hi"], st["n_proc"]
    # Output passes read from the local view of the inputs (gz ranges
    # spilled to plain scratch files, other files as-is).
    files_local = st["files_local"]

    # Representative read per cluster (humid.cc:223-232).
    if cl.num_clusters:
        rep_reads = np.sort(first_occ[cl.max_leaf])
    else:
        rep_reads = np.zeros(0, np.int64)

    # Local per-read cluster ids (0 = filtered, humid.cc:271-278) —
    # only the annotated writer consumes them.
    filtered = st["filtered"]
    cluster_of_local = None
    if write_annotated:
        cluster_of_local = np.zeros(hi - lo, np.int64)
        if len(st["usable"]):
            inv_local = global_unique_index(st["uniq"], st["usable"])
            cluster_of_local[np.flatnonzero(~filtered)] = \
                cl.labels[inv_local]

    os.makedirs(dir_name, exist_ok=True)
    dedup_names = make_file_names(list(files), dir_name, "dedup")
    ann_names = make_file_names(list(files), dir_name, "annotated")

    import time as _time

    if write_dedup:
        t = log.start("Writing filtered results")
        _tw = _time.perf_counter()
        sel = rep_reads[(rep_reads >= lo) & (rep_reads < hi)] - lo
        if st["span_tables"] is not None:
            from ..pipeline import _write_selected_spans_to

            _write_selected_spans_to(files_local,
                                     _part_names(dedup_names, p),
                                     sel, st["span_tables"])
        else:
            _write_range_selected(files_local, _part_names(dedup_names, p),
                                  sel, lo, hi, batch_records,
                                  start_offsets=st["start_offsets"])
        st["timings"]["write_dedup"] = _time.perf_counter() - _tw
        log.end(t)
    if write_annotated:
        t = log.start("Writing annotated results")
        _tw = _time.perf_counter()
        if st["span_tables"] is not None and all(
                tb[2] is not None for tb in st["span_tables"]):
            from ..pipeline import _write_annotated_spans

            _write_annotated_spans(files_local, _part_names(ann_names, p),
                                   cluster_of_local, st["span_tables"])
        else:
            _write_range_annotated(files_local, _part_names(ann_names, p),
                                   cluster_of_local, lo, hi, batch_records,
                                   start_offsets=st["start_offsets"])
        st["timings"]["write_annotated"] = _time.perf_counter() - _tw
        log.end(t)
    # Scaling-efficiency report (VERDICT r3 #10): exchange per-host
    # per-phase timings over the existing gather and summarize.  One
    # command away on real multi-host hardware:
    #   HUMID_TPU_SCALING_REPORT=1 python -m humid_tpu --coordinator ...
    if n_proc > 1 and (all_gather is not None
                       or jax.process_count() == n_proc):
        from .multihost import default_all_gather

        gather = all_gather if all_gather is not None else \
            default_all_gather
        mine = np.array([st["timings"].get(k, 0.0)
                         for k in _SCALING_PHASES], np.float64)
        (rows,) = gather([mine])
        report = scaling_report(np.stack(
            [np.asarray(r, np.float64) for r in rows]), n_proc)
        LAST_SCALING_REPORT.clear()
        LAST_SCALING_REPORT.update(report)
        if p == 0 and os.environ.get("HUMID_TPU_SCALING_REPORT"):
            import json as _json
            import sys as _sys

            print("humid_tpu scaling report: "
                  + _json.dumps(report), file=_sys.stderr)
    if st["spill_dir"]:
        import shutil

        shutil.rmtree(st["spill_dir"], ignore_errors=True)
    if run_stats and p == 0:
        write_statistics(
            counts=counts,
            degrees=np.diff(st["indptr"]),
            sizes=cl.size,
            total=st["total_records"],
            usable=int(counts.sum()),
            unique=len(counts),
            num_clusters=cl.num_clusters,
            dir_name=dir_name,
        )

    if barrier is None and n_proc > 1 and jax.process_count() == 1:
        # Uncoordinated processes (no jax.distributed, no injected
        # barrier): host 0 cannot know the others finished, so leave the
        # part files for an external finalize_outputs() call.
        log.close()
        return cl, counts, first_occ, st["uniq"]
    (barrier if barrier is not None else default_barrier)()
    if finalize and p == 0:
        targets = (dedup_names if write_dedup else []) + \
            (ann_names if write_annotated else [])
        finalize_outputs(targets, n_proc)
    log.close()
    return cl, counts, first_occ, st["uniq"]
