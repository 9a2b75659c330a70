"""Real 2-process jax.distributed run on the CPU backend.

The simulated-hosts tests inject ``all_gather``; this one launches two
actual processes coordinated by ``jax.distributed`` through the CLI's
``--coordinator`` flags and asserts the finalized outputs are
byte-identical to a single-host run (VERDICT r1 item 3).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_proc", [2, 3])
def test_distributed_cli_matches_single_host(tmp_path, n_proc):
    # 500 reads over 3 processes exercises uneven host record ranges.
    gen_dataset(np.random.default_rng(21), str(tmp_path), n_reads=500,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]

    # Single-host reference outputs (in-process).
    from humid_tpu.pipeline import run

    ref_dir = tmp_path / "ref"
    run(files, dir_name=str(ref_dir), log_name=os.devnull,
        write_dedup=True, write_annotated=True, run_stats=True)

    port = _free_port()
    out_dir = str(tmp_path / "dist")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HUMID_TPU_SCALING_REPORT"] = "1"
    # Each CPU process keeps its own single device.
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(n_proc):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "humid_tpu",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_proc), "--process-id", str(pid),
             "-d", out_dir, "-s", "-a", "-l", os.devnull] + files,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err.decode()[-2000:]
    # The scaling report rode the real DCN gather and host 0 printed it.
    import json as _json

    line = next(ln for ln in outs[0][2].decode().splitlines()
                if ln.startswith("humid_tpu scaling report:"))
    rep = _json.loads(line.split(":", 1)[1])
    assert rep["n_hosts"] == n_proc
    assert 0.0 < rep["efficiency"] <= 1.0
    assert len(rep["per_host_s"]) == n_proc

    for f in sorted(os.listdir(ref_dir)):
        a = (ref_dir / f).read_bytes()
        b = open(os.path.join(out_dir, f), "rb").read()
        assert a == b, (
            f"{f} differs between single-host and {n_proc}-process")


def test_distributed_cli_gz_matches_single_host(tmp_path):
    """Real 2-process run over GZIP inputs: the per-host range spill
    (parallel/pipeline.py::spill_gz_ranges) must leave the finalized
    outputs content-identical to the single-host run (VERDICT r2 #4)."""
    import gzip

    gen_dataset(np.random.default_rng(37), str(tmp_path), n_reads=400,
                n_files=1, umi_style="colon", gz=True)
    files = [str(tmp_path / "file0.fastq.gz")]

    from humid_tpu.pipeline import run

    ref_dir = tmp_path / "ref"
    run(files, dir_name=str(ref_dir), log_name=os.devnull,
        write_dedup=True, write_annotated=True, run_stats=True)

    port = _free_port()
    out_dir = str(tmp_path / "dist")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "humid_tpu",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "-d", out_dir, "-s", "-a", "-l", os.devnull] + files,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-2000:]

    for f in sorted(os.listdir(ref_dir)):
        ap, bp = str(ref_dir / f), os.path.join(out_dir, f)
        if f.endswith(".gz"):
            assert gzip.open(ap).read() == gzip.open(bp).read(), f
        else:
            assert open(ap, "rb").read() == open(bp, "rb").read(), f
