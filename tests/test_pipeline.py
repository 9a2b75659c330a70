"""Golden end-to-end tests: full pipeline vs the literal-semantics oracle.

The reference binary cannot be built in this environment (its submodules
are not checked out), so the oracle (tests/oracle.py) — an independent
string-based transcription of the reference's algorithms — provides the
expected duplicate sets, annotations, and statistics.
"""

import os

import numpy as np
import pytest

from humid_tpu.pipeline import run
from humid_tpu.io.names import make_file_name

from genfastq import gen_dataset, parse_fastq
from oracle import oracle_run


def _expected_dedup(files_records, rep_tuples, f):
    out = []
    for t in rep_tuples:
        name, seq = files_records[f][t]
        out.append((name, seq, "+", "F" * len(seq)))
    return out


def _expected_annotated(files_records, ids, f, n_tuples):
    out = []
    for t in range(n_tuples):
        name, seq = files_records[f][t]
        out.append((f"{name}:{ids[t]}", seq, "+", "F" * len(seq)))
    return out


def _check_case(tmp_path, rng, *, n_files=1, umi_style="none", gz=False,
                distance=1, word_length=24, edit=False, maximum=False,
                ragged=False, unequal=False, n_reads=250,
                batch_records=1 << 19, pool_size=40):
    src = tmp_path / "in"
    out = tmp_path / "out"
    os.makedirs(src, exist_ok=True)
    paths, files_records = gen_dataset(
        rng, str(src), n_reads=n_reads, n_files=n_files, umi_style=umi_style,
        gz=gz, ragged=ragged, unequal_lengths=unequal,
        read_len=18 if edit else 30, pool_size=pool_size,
    )
    res = run(
        list(paths),
        word_length=word_length,
        distance=distance,
        log_name=str(out / "log.txt"),
        dir_name=str(out),
        run_stats=True,
        write_dedup=True,
        write_annotated=True,
        edit=edit,
        maximum=maximum,
        batch_records=batch_records,
    )
    exp = oracle_run(
        files_records, word_length=word_length, distance=distance,
        edit=edit, maximum=maximum,
    )

    # scalar stats
    assert res.total == exp.total
    assert res.usable == exp.usable
    assert res.unique == exp.unique
    assert res.clusters == len(exp.clusters)

    # dedup output files: byte-level record equality
    for f, p in enumerate(paths):
        dedup = parse_fastq(make_file_name(p, str(out), "dedup"))
        assert dedup == _expected_dedup(files_records, exp.rep_tuples, f), (
            f"dedup mismatch file {f}"
        )
        annotated = parse_fastq(make_file_name(p, str(out), "annotated"))
        assert annotated == _expected_annotated(
            files_records, exp.cluster_of_read, f, exp.total
        ), f"annotated mismatch file {f}"

    # statistics files
    def read_hist(name):
        with open(out / name) as fh:
            return {int(a): int(b) for a, b in
                    (l.split() for l in fh if l.strip())}

    assert read_hist("counts.dat") == exp.counts_hist
    assert read_hist("neigh.dat") == exp.neigh_hist
    assert read_hist("clusters.dat") == exp.cluster_hist
    with open(out / "stats.dat") as fh:
        lines = dict(l.strip().split(": ") for l in fh)
    assert int(lines["total"]) == exp.total
    assert int(lines["usable"]) == exp.usable
    assert int(lines["unique"]) == exp.unique
    assert int(lines["clusters"]) == len(exp.clusters)
    return res, exp


def test_single_end_no_umi(tmp_path):
    _check_case(tmp_path, np.random.default_rng(1))


def test_single_end_gz(tmp_path):
    _check_case(tmp_path, np.random.default_rng(2), gz=True)


def test_paired_umi_underscore(tmp_path):
    _check_case(tmp_path, np.random.default_rng(3), n_files=2,
                umi_style="underscore")


def test_paired_umi_colon(tmp_path):
    _check_case(tmp_path, np.random.default_rng(4), n_files=2,
                umi_style="colon")


def test_three_file_mode(tmp_path):
    _check_case(tmp_path, np.random.default_rng(5), n_files=3)


@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_mismatch_sweep(tmp_path, m):
    _check_case(tmp_path, np.random.default_rng(10 + m), distance=m)


def test_maximum_clustering(tmp_path):
    _check_case(tmp_path, np.random.default_rng(20), maximum=True,
                distance=2)


def test_edit_distance(tmp_path):
    _check_case(tmp_path, np.random.default_rng(21), edit=True,
                word_length=18, n_reads=120)


def test_ragged_reads_padding_filters(tmp_path):
    _check_case(tmp_path, np.random.default_rng(22), ragged=True)


def test_unequal_file_lengths_stop_at_shortest(tmp_path):
    _check_case(tmp_path, np.random.default_rng(23), n_files=2,
                unequal=True)


def test_small_batches_exercise_lockstep(tmp_path):
    _check_case(tmp_path, np.random.default_rng(24), n_files=2,
                umi_style="underscore", batch_records=17)


def test_word_length_sweep(tmp_path):
    for wl in (8, 16, 23, 33):
        _check_case(tmp_path / f"wl{wl}", np.random.default_rng(30 + wl),
                    n_files=2, word_length=wl, n_reads=120)


def test_umi_longer_than_word(tmp_path):
    # wordLength < UMI size: header UMI is cut, files contribute nothing.
    _check_case(tmp_path, np.random.default_rng(40), umi_style="underscore",
                word_length=3, n_reads=100)


@pytest.mark.parametrize(
    "seed", [101, 202, 303, 404, 505, 606, 707, 808, 909, 1010])
@pytest.mark.parametrize("span_cache", [False, True],
                         ids=["default", "spans"])
def test_fuzz_random_config_matches_oracle(tmp_path, seed, span_cache,
                                           monkeypatch):
    """Deterministic config fuzz: random flag/dataset combinations the
    hand-written cases don't enumerate, checked against the string
    oracle end to end (outputs + stats) — with both the default writer
    and the forced span-cache writer (gz configs exercise its
    fallback)."""
    if span_cache:
        monkeypatch.setenv("HUMID_TPU_SPAN_CACHE", "1")
    rng = np.random.default_rng(seed)
    n_files = int(rng.integers(1, 4))
    cfg = dict(
        n_files=n_files,
        umi_style=["none", "underscore", "colon"][int(rng.integers(0, 3))],
        gz=bool(rng.integers(0, 2)),
        distance=int(rng.integers(0, 3)),
        word_length=int(rng.integers(12, 33)),
        edit=bool(rng.integers(0, 4) == 0),
        maximum=bool(rng.integers(0, 2)),
        ragged=bool(rng.integers(0, 2)),
        unequal=bool(rng.integers(0, 2)) and n_files > 1,
        n_reads=int(rng.integers(100, 400)),
        batch_records=int(rng.choice([64, 1 << 10, 1 << 19])),
    )
    _check_case(tmp_path, rng, **cfg)


def test_cli_smoke(tmp_path):
    from humid_tpu.cli import main
    src = tmp_path / "in"
    os.makedirs(src)
    paths, _ = gen_dataset(np.random.default_rng(50), str(src), n_reads=50)
    rc = main(["-d", str(tmp_path / "o"), "-s", "-a",
               "-l", str(tmp_path / "log"), paths[0]])
    assert rc == 0
    assert os.path.exists(make_file_name(paths[0], str(tmp_path / "o"),
                                         "dedup"))
    assert os.path.exists(tmp_path / "o" / "stats.dat")


def _missing_input(d):
    return str(d / "missing.fastq")


def _empty_input(d):
    p = d / "empty.fastq"
    p.write_bytes(b"")
    return str(p)


def _corrupt_gz_input(d):
    p = d / "corrupt.fastq.gz"
    p.write_bytes(b"\x1f\x8b\x08\x00garbage")
    return str(p)


@pytest.mark.parametrize(
    "make_input", [_missing_input, _empty_input, _corrupt_gz_input])
def test_cli_input_errors_exit_cleanly(tmp_path, capsys, make_input):
    """Bad inputs produce `humid-tpu: error: ...` + exit 1, no traceback."""
    from humid_tpu.cli import main
    path = make_input(tmp_path)
    rc = main(["-d", str(tmp_path / "o"), "-l", os.devnull, path])
    assert rc == 1
    assert "humid-tpu: error:" in capsys.readouterr().err


def test_cli_truncated_gzip_exits_cleanly(tmp_path, capsys):
    import gzip
    from humid_tpu.cli import main
    rec = b"@r1\nACGTACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIIIIIII\n"
    data = gzip.compress(rec * 50)
    p = tmp_path / "trunc.fastq.gz"
    p.write_bytes(data[:len(data) // 2])
    rc = main(["-d", str(tmp_path / "o"), "-l", os.devnull, str(p)])
    assert rc == 1
    assert "humid-tpu: error:" in capsys.readouterr().err


def test_pipeline_reports_phase_timings(tmp_path):
    import numpy as np
    from genfastq import gen_dataset
    from humid_tpu.pipeline import run

    gen_dataset(np.random.default_rng(0), str(tmp_path), n_reads=100)
    res = run([str(tmp_path / "file0.fastq")],
              dir_name=str(tmp_path / "out"), log_name=os.devnull)
    timings = res.extra["timings"]
    assert "Reading data" in timings
    assert all(v >= 0 for v in timings.values())


def test_pipeline_mxu_path_outputs(tmp_path):
    """End-to-end run forced through the dense one-hot matmul tile scan
    produces byte-identical outputs to the default path."""
    import genfastq

    genfastq.gen_dataset(np.random.default_rng(33), str(tmp_path),
                         n_reads=400, n_files=1, umi_style="none")
    files = [str(tmp_path / "file0.fastq")]
    d1 = tmp_path / "out_default"
    d2 = tmp_path / "out_mxu"
    run(files, dir_name=str(d1), log_name=os.devnull, run_stats=True,
        write_annotated=True)
    run(files, dir_name=str(d2), log_name=os.devnull, run_stats=True,
        write_annotated=True,
        neighbor_opts={"impl": "mxu", "strategy": "dense"})
    for f in sorted(os.listdir(d1)):
        assert (d1 / f).read_bytes() == (d2 / f).read_bytes(), f


def test_span_writer_empty_mate_no_crash(tmp_path, monkeypatch):
    """A zero-byte lockstep mate (total=0 tuples) must produce empty
    outputs, not an mmap crash, under the forced span writer."""
    from humid_tpu.pipeline import run

    p0 = tmp_path / "a.fastq"
    p0.write_bytes(b"@r1\nACGTACGTACGTACGTACGTACGT\n+\n"
                   b"IIIIIIIIIIIIIIIIIIIIIIII\n")
    p1 = tmp_path / "b.fastq"
    p1.write_bytes(b"")
    monkeypatch.setenv("HUMID_TPU_SPAN_CACHE", "1")
    res = run([str(p0), str(p1)], dir_name=str(tmp_path / "o"),
              log_name=os.devnull)
    assert res.total == 0
    assert (tmp_path / "o" / "a_dedup.fastq").read_bytes() == b""
    assert (tmp_path / "o" / "b_dedup.fastq").read_bytes() == b""


def test_part_writer_compresses_by_final_name(tmp_path):
    """.partNNNNN output names hide the .gz suffix; _pipelined_write
    must still gzip-compress them (decided by the FINAL name)."""
    import gzip

    import numpy as np
    from humid_tpu.pipeline import _write_selected_spans_to

    rec = b"@r0\nACGT\n+\nIIII\n"
    src = tmp_path / "x.fastq"   # plain content
    src.write_bytes(rec * 3)
    starts = np.arange(3, dtype=np.int64) * len(rec)
    out = str(tmp_path / "x_dedup.fastq.gz.part00000")
    _write_selected_spans_to(
        [str(src)], [out], np.array([1], np.int64),
        [(starts, 3 * len(rec), None)])
    assert gzip.decompress(open(out, "rb").read()) == rec


def test_span_writer_mixed_crlf_falls_back(tmp_path, monkeypatch):
    """A single CRLF record mid-file invalidates the span table (raw
    spans would differ from canonical records); the forced span mode
    must fall back to the framing writer and still match the default
    writer byte for byte."""
    from humid_tpu.pipeline import run

    rec = b"@r%d\nACGTACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIIIIIII\n"
    crlf = (b"@rx\r\nACGTACGTACGTACGTACGTACGT\r\n+\r\n"
            b"IIIIIIIIIIIIIIIIIIIIIIII\r\n")
    p = tmp_path / "m.fastq"
    p.write_bytes(b"".join(rec % i for i in range(40)) + crlf
                  + b"".join(rec % i for i in range(40, 80)))

    run([str(p)], dir_name=str(tmp_path / "d0"), log_name=os.devnull)
    monkeypatch.setenv("HUMID_TPU_SPAN_CACHE", "1")
    run([str(p)], dir_name=str(tmp_path / "d1"), log_name=os.devnull)
    a = (tmp_path / "d0" / "m_dedup.fastq").read_bytes()
    b = (tmp_path / "d1" / "m_dedup.fastq").read_bytes()
    assert a == b and len(a) > 0


@pytest.mark.parametrize("edit", [False, True], ids=["hamming", "edit"])
def test_all_device_paths_match_all_host(tmp_path, edit, monkeypatch):
    """Every stage's device variant composed at once (device unique +
    device tile/bucketed search + device edit verify) produces outputs
    byte-identical to the all-host default."""
    from humid_tpu.cli import main

    gen_dataset(np.random.default_rng(778), str(tmp_path), n_reads=500,
                n_files=2, umi_style="colon", ragged=True)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    flags = (["-e"] if edit else [])
    main(["-d", str(tmp_path / "host"), "-s", "-a", "-l", os.devnull,
          *flags, *files])
    monkeypatch.setenv("HUMID_TPU_UNIQUE", "device")
    if edit:
        monkeypatch.setenv("HUMID_TPU_EDIT_VERIFY", "device")
    else:
        monkeypatch.setenv("HUMID_TPU_STRATEGY", "bucketed")
        monkeypatch.setenv("HUMID_TPU_IMPL", "mxu")
    main(["-d", str(tmp_path / "dev"), "-s", "-a", "-l", os.devnull,
          *flags, *files])
    for f in sorted(os.listdir(tmp_path / "host")):
        assert (tmp_path / "host" / f).read_bytes() == \
            (tmp_path / "dev" / f).read_bytes(), f
