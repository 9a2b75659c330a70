"""Fused device-resident pipeline (ops/fused.py) equivalence tests.

The fused route must reproduce the host engines' outputs EXACTLY: the
unique table/counts/first-occurrence/inverse of ops.unique.unique_words,
the pair list of the host runs engine, and (for -x) the component
labels — across word widths, distances, filtered reads, degenerate run
structures (mid runs, big runs, dense fallback), feeder growth, and the
full CLI surface.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402


@pytest.fixture(autouse=True)
def _device_budget(monkeypatch):
    """The CPU backend reports no device memory limit, so the fused
    route would never be eligible here; these tests exercise the fused
    programs themselves, so they give the device a 16 GiB budget."""
    from humid_tpu.ops import fused as F

    monkeypatch.setattr(F, "device_bytes_limit", lambda: 16 << 30)


def _gen_packed(n, wl, dup=6, seed=0, mut_p=0.3):
    from humid_tpu import words as W

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(max(n // dup, 1), wl)).astype(np.uint8)
    codes = pool[rng.integers(0, len(pool), n)].copy()
    mut = rng.random(n) < mut_p
    if mut.any():
        codes[np.flatnonzero(mut),
              rng.integers(0, wl, int(mut.sum()))] = rng.integers(
            0, 4, int(mut.sum()))
    return W.pack_words(codes)


def _run_fused(packed, wl, m, *, filtered=None, want_inverse=False,
               want_labels=False, seed=1, **kw):
    from humid_tpu.ops.fused import DeviceFeeder, FusedPipeline

    n, w = packed.shape
    if filtered is None:
        filtered = np.zeros(n, bool)
    # Tiny feeder estimate + chunk: exercises buffer growth, mid-stream
    # chunk flushes that split staged batches, and final-flush padding.
    feeder = DeviceFeeder(w, max(n // 3, 1), chunk_rows=1024)
    rng = np.random.default_rng(seed)
    i = 0
    while i < n:
        j = min(n, i + int(rng.integers(1, 700)))
        keep = ~filtered[i:j]
        feeder.push(packed[i:j][keep] if not keep.all()
                    else packed[i:j])
        i = j
    fp = FusedPipeline(feeder, n, filtered, word_length=wl, max_dist=m,
                       want_inverse=want_inverse,
                       want_labels=want_labels, **kw)
    fp.unique()
    return fp


def _host_reference(packed, wl, m, *, filtered=None):
    from humid_tpu.ops import find_neighbor_pairs, unique_words

    if filtered is not None and filtered.any():
        usable = packed[~filtered]
    else:
        usable = packed
    uniq, counts, first_u, inv = unique_words(usable, want_inverse=True)
    if filtered is not None and filtered.any():
        u2r = np.flatnonzero(~filtered)
        first = u2r[first_u] if len(first_u) else first_u
        inv_by_read = np.full(len(packed), -1, np.int64)
        inv_by_read[u2r] = inv
    else:
        first = first_u
        inv_by_read = inv
    pa, pb = find_neighbor_pairs(uniq, m, strategy="runs",
                                 word_length=wl)
    return uniq, counts, first, inv_by_read, (pa, pb)


@pytest.mark.parametrize("wl,m,n,seed", [
    (24, 1, 30_000, 0),
    (24, 2, 12_000, 1),
    (24, 3, 6_000, 2),
    (16, 1, 20_000, 3),
    (8, 2, 8_000, 4),     # tiny words: huge runs, dense-ish structure
    (33, 1, 10_000, 5),   # 3 lanes (no word64 fast path on host mid runs)
    (64, 2, 6_000, 6),    # 4 lanes
])
def test_fused_matches_host(wl, m, n, seed):
    packed = _gen_packed(n, wl, seed=seed)
    uniq, counts, first, _, (pa, pb) = _host_reference(packed, wl, m)
    fp = _run_fused(packed, wl, m)
    fc, ff, _ = fp.tables()
    fa, fb = fp.neighbors()
    assert fp.k == len(uniq)
    assert np.array_equal(fp.table(), uniq)
    assert np.array_equal(fc, counts)
    assert np.array_equal(ff, first)
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)


def test_fused_filtered_and_inverse():
    wl, m, n = 24, 1, 20_000
    packed = _gen_packed(n, wl, seed=7)
    filtered = np.random.default_rng(8).random(n) < 0.15
    uniq, counts, first, inv, (pa, pb) = _host_reference(
        packed, wl, m, filtered=filtered)
    fp = _run_fused(packed, wl, m, filtered=filtered, want_inverse=True)
    fc, ff, finv = fp.tables()
    fa, fb = fp.neighbors()
    assert fp.k == len(uniq)
    assert np.array_equal(fp.table(), uniq)
    assert np.array_equal(fc, counts)
    assert np.array_equal(ff, first)
    assert np.array_equal(finv, inv)
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)


def test_fused_mid_and_big_runs():
    """Force the host mid-run ladder (d_cap=1) and the big-run device
    tile fallback (tiny run_cap) — outputs still equal the host runs
    engine's."""
    wl, m = 24, 1
    packed = _gen_packed(9_000, wl, dup=40, seed=9, mut_p=0.6)
    uniq, _, _, _, (pa, pb) = _host_reference(packed, wl, m)
    fp = _run_fused(packed, wl, m, d_cap=1, run_cap=24)
    fa, fb = fp.neighbors()
    from humid_tpu.ops.neighbors import LAST_DECISION

    assert LAST_DECISION["strategy"] == "fused"
    assert LAST_DECISION["d_max"] == 1
    assert LAST_DECISION["decode"] == "full"  # big runs force full
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)


def test_fused_sparse_decode_with_mid_runs():
    """RARE mid runs on an otherwise sparse table: the sparse decode
    path gathers just the mid-run members' rows from the device — the
    table and order permutations never come down."""
    from humid_tpu import words as W
    from humid_tpu.ops.neighbors import LAST_DECISION

    wl, m = 24, 1
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 4, size=(20_000, wl)).astype(np.uint8)
    # 30 groups of 6 words sharing their first-half segment: runs of
    # length 6 in partition 0 — longer than d_max+1 at d_cap=2, far
    # under run_cap, and <1% of the table.
    for g in range(30):
        rows = slice(200 * g, 200 * g + 6)
        codes[rows, :12] = codes[200 * g, :12]
    packed = W.pack_words(codes)
    uniq, _, _, _, (pa, pb) = _host_reference(packed, wl, m)
    fp = _run_fused(packed, wl, m, d_cap=2)
    fa, fb = fp.neighbors()
    assert LAST_DECISION["decode"] == "sparse"
    # 180 mid rows sit under the u//50 ladder threshold, so only the
    # always-launched base sweeps (d <= 2) ran and the length-6 groups
    # resolve through the host ladder via the sparse row gather.
    assert LAST_DECISION["d_max"] == 2
    assert fp.uniq is None  # the table never came down
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)


def test_fused_degenerate_dense_fallback():
    """A table that is one giant run in every partition (single
    duplicated word pool with 1-base mutations of ONE position) trips
    the big-row guard and falls back to the dense strategy — same
    pairs."""
    from humid_tpu import words as W
    from humid_tpu.ops import find_neighbor_pairs

    wl, m = 24, 1
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, wl).astype(np.uint8)
    codes = np.tile(base, (4_000, 1))
    pos = rng.integers(0, 2, 4_000)  # mutate only positions 0-1
    codes[np.arange(4_000), pos] = rng.integers(0, 4, 4_000)
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words

    uniq = unique_words(packed, want_inverse=False)[0]
    pa, pb = find_neighbor_pairs(uniq, m, strategy="dense",
                                 word_length=wl)
    fp = _run_fused(packed, wl, m, run_cap=2)
    fa, fb = fp.neighbors()
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)


def test_fused_device_labels_match_components():
    """-x: on-device label propagation over the resident matches (+ the
    uploaded mid/big edges) equals host connected components."""
    from humid_tpu.ops import pairs_to_csr
    from humid_tpu.cluster.exact import cluster_exact

    wl, m = 24, 2
    packed = _gen_packed(15_000, wl, seed=12)
    uniq, counts, _, _, (pa, pb) = _host_reference(packed, wl, m)
    fp = _run_fused(packed, wl, m, want_labels=True, d_cap=2,
                    run_cap=64)
    fa, fb = fp.neighbors()
    assert np.array_equal(fa, pa) and np.array_equal(fb, pb)
    assert fp.has_matches
    cc = fp.device_labels()
    # Host truth: min unique index per component.
    import numpy as _np

    parent = _np.arange(len(uniq))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(pa.tolist(), pb.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    truth = _np.array([find(i) for i in range(len(uniq))])
    assert np.array_equal(cc, truth)
    # And the finalized clustering equals the host exact -x clustering.
    from humid_tpu.cluster.exact import cluster_max_from_components

    indptr, indices = pairs_to_csr(pa, pb, len(uniq))
    ch = cluster_exact(counts, indptr, indices, maximum=True)
    cd = cluster_max_from_components(counts, indptr, indices, cc)
    assert np.array_equal(ch.labels, cd.labels)
    assert np.array_equal(ch.max_leaf, cd.max_leaf)
    assert np.array_equal(ch.size, cd.size)


def test_fused_empty_and_degenerate_counts():
    from humid_tpu import words as W

    wl = 24
    w = W.num_lanes(wl)
    # all filtered
    packed = _gen_packed(500, wl, seed=13)
    filtered = np.ones(500, bool)
    fp = _run_fused(packed, wl, 1, filtered=filtered, want_inverse=True)
    assert fp.k == 0
    fc, ff, finv = fp.tables()
    assert len(fc) == 0 and len(ff) == 0
    assert np.all(finv == -1)
    fa, fb = fp.neighbors()
    assert len(fa) == 0
    # single unique word
    packed = np.tile(_gen_packed(1, wl, seed=14), (300, 1))
    fp = _run_fused(packed, wl, 1)
    assert fp.k == 1
    fa, fb = fp.neighbors()
    assert len(fa) == 0
    assert np.array_equal(fp.table(), packed[:1])


def test_fused_pipeline_cli_outputs(tmp_path, monkeypatch):
    """Full pipeline with HUMID_TPU_FUSED=1: all output files
    byte-identical to the default route, for directional and -x with
    annotate + stats, on data with filtered (N-containing) reads."""
    from humid_tpu.pipeline import run

    gen_dataset(np.random.default_rng(21), str(tmp_path), n_reads=1500,
                n_files=2, umi_style="underscore", ragged=True,
                n_frac=0.1)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    for extra in ({}, {"maximum": True}):
        ref_dir = tmp_path / ("ref" + str(len(extra)))
        fus_dir = tmp_path / ("fus" + str(len(extra)))
        monkeypatch.delenv("HUMID_TPU_FUSED", raising=False)
        run(files, dir_name=str(ref_dir), log_name=os.devnull,
            write_dedup=True, write_annotated=True, run_stats=True,
            **extra)
        monkeypatch.setenv("HUMID_TPU_FUSED", "1")
        res = run(files, dir_name=str(fus_dir), log_name=os.devnull,
                  write_dedup=True, write_annotated=True,
                  run_stats=True, **extra)
        monkeypatch.delenv("HUMID_TPU_FUSED")
        assert res.extra["engine"]["strategy"] == "fused"
        for f in sorted(os.listdir(ref_dir)):
            assert (ref_dir / f).read_bytes() == \
                (fus_dir / f).read_bytes(), f


def test_use_fused_pipeline_gating(monkeypatch):
    import humid_tpu._backend as B

    monkeypatch.setenv("HUMID_TPU_FUSED", "1")
    assert B.use_fused_pipeline() is True
    monkeypatch.setenv("HUMID_TPU_FUSED", "0")
    assert B.use_fused_pipeline() is False
    monkeypatch.delenv("HUMID_TPU_FUSED")
    # Colocated + calibrated: routes only when the measured fused
    # constant beats the best phase-wise alternative by >10%.
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu",
         "colocated_device": True, "forced": None})
    base = {
        "unique_host_ns": 20.0, "unique_device_ns": 100.0,
        "neighbors_runs_ns": 100.0, "neighbors_bucketed_ns": 900.0,
        "neighbors_runs_device_ns": 300.0,
        "cc_host_ns": 10.0, "cc_device_ns": 100.0,
        "probe_n": 1000, "probe_u": 500,
    }
    # alt = 20 + 100 * 0.5 = 70
    monkeypatch.setitem(B.__dict__, "_CALIB",
                        dict(base, pipeline_fused_ns=50.0))
    assert B.use_fused_pipeline() is True
    monkeypatch.setitem(B.__dict__, "_CALIB",
                        dict(base, pipeline_fused_ns=65.0))
    assert B.use_fused_pipeline() is False  # within hysteresis
    # A cache that predates the fused probe answers False, never
    # re-measures mid-run.
    monkeypatch.setitem(B.__dict__, "_CALIB", dict(base))
    assert B.use_fused_pipeline() is False
    # Not colocated: never.
    monkeypatch.setitem(
        B.__dict__, "_PROFILE",
        {"backend": "cpu",
         "colocated_device": False, "forced": None})
    monkeypatch.setitem(B.__dict__, "_CALIB",
                        dict(base, pipeline_fused_ns=1.0))
    assert B.use_fused_pipeline() is False


def test_feeder_positions_and_growth():
    """Feeder rows land at their usable-read index across chunk splits,
    growth, and final padding."""
    from humid_tpu.ops.fused import DeviceFeeder

    rng = np.random.default_rng(31)
    w = 2
    n = 5_000
    packed = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
        .astype(np.uint32)
    feeder = DeviceFeeder(w, 64, chunk_rows=512)
    i = 0
    while i < n:
        j = min(n, i + int(rng.integers(1, 300)))
        feeder.push(packed[i:j])
        i = j
    buf = np.asarray(feeder.finish())
    assert feeder.n == n
    assert np.array_equal(buf[:n], packed)
    assert np.all(buf[n:] == 0xFFFFFFFF)  # tail rows sort last


def test_fused_capacity_fallback(tmp_path, monkeypatch):
    """A feeder growth past the device budget (pre-run estimate
    undershot) falls back to the host pass-1 path mid-run and still
    produces byte-identical outputs (review r5 fix)."""
    import functools

    from humid_tpu import pipeline as P
    from humid_tpu.ops import fused as F
    from humid_tpu.pipeline import run

    gen_dataset(np.random.default_rng(55), str(tmp_path), n_reads=3000,
                n_files=1, umi_style="none")
    files = [str(tmp_path / "file0.fastq")]
    ref_dir = tmp_path / "ref"
    run(files, dir_name=str(ref_dir), log_name=os.devnull,
        write_dedup=True, write_annotated=True, run_stats=True)

    monkeypatch.setenv("HUMID_TPU_FUSED", "1")
    # Tiny initial estimate + chunk, and a budget that refuses growth:
    # pass 1 starts fused, trips FusedCapacityExceeded, and re-reads.
    monkeypatch.setattr(P, "_input_bytes_estimate", lambda files: 1)
    monkeypatch.setattr(
        F, "DeviceFeeder",
        functools.partial(F.DeviceFeeder, chunk_rows=256))
    monkeypatch.setattr(F, "fused_fits", lambda rows, w: rows <= 1024)
    fb_dir = tmp_path / "fb"
    res = run(files, dir_name=str(fb_dir), log_name=os.devnull,
              write_dedup=True, write_annotated=True, run_stats=True)
    assert res.extra["engine"]["strategy"] != "fused"
    for f in sorted(os.listdir(ref_dir)):
        assert (ref_dir / f).read_bytes() == (fb_dir / f).read_bytes(), f


def test_overlap_unique_optin_excludes_fused(tmp_path, monkeypatch):
    """HUMID_TPU_OVERLAP_UNIQUE=1 is an explicit unique-engine opt-in:
    it keeps the overlapped host path even when the fused route is
    forced on (review r5 fix)."""
    from humid_tpu.pipeline import run

    gen_dataset(np.random.default_rng(56), str(tmp_path), n_reads=500,
                n_files=1, umi_style="none")
    files = [str(tmp_path / "file0.fastq")]
    monkeypatch.setenv("HUMID_TPU_FUSED", "1")
    monkeypatch.setenv("HUMID_TPU_OVERLAP_UNIQUE", "1")
    res = run(files, dir_name=str(tmp_path / "out"),
              log_name=os.devnull, write_dedup=False)
    assert res.extra["engine"]["strategy"] != "fused"
    assert any(k.startswith("unique counting (overlapped)")
               for k, _ in [(k, v) for k, v in
                            res.extra["timings"].items()])


def test_input_bytes_estimate_sniffs_gzip(tmp_path):
    """Gzip detection is by content, not suffix — a renamed gz file
    still gets the 4x in-memory scaling (review r5 fix)."""
    import gzip as _gzip

    from humid_tpu.pipeline import _input_bytes_estimate

    plain = tmp_path / "x.fastq"
    plain.write_bytes(b"@r\nACGT\n+\nIIII\n" * 1000)
    gz_noext = tmp_path / "y.fastq"  # gzip content, plain suffix
    with _gzip.open(gz_noext, "wb") as f:
        f.write(b"@r\nACGT\n+\nIIII\n" * 1000)
    sz = os.path.getsize(gz_noext)
    assert _input_bytes_estimate([str(gz_noext)]) == 4 * sz
    assert _input_bytes_estimate([str(plain)]) == os.path.getsize(plain)
