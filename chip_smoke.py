"""On-card smoke test: every device route of the dedup CLI at full size.

    python chip_smoke.py            # one GPU, the default
    python chip_smoke.py --four     # the four-card paths only

Drives the pipeline through the entry points a user calls
(``humid_tpu.cli``) on a paired-end 2x150 bp dataset with BCL-Convert
``:UMI`` header UMIs (8 nt), skewed duplicate-family sizes and single
substitutions, generated from ``--seed`` (4M read pairs by default: one
targeted-panel or MiSeq run; the unique table holds >= 1M words).
Every phase byte-compares every output file with ``baseline/humid_ref``
run on the same flags, and every forced phase asserts that its device
engine ran and that the arrays it produced live on a ``gpu`` device.

Setup (timed as set-up): builds the native extensions and
``baseline/humid_ref`` from the tracked sources.  Generated data and
outputs go to ``.smoke/`` in the checkout and are deleted at the end.

One JAX process per card: the default mode runs everything in this
process; ``--four`` runs its four-process leg (one process per card,
``CUDA_VISIBLE_DEVICES``) before this process touches a card.

Exits non-zero, printing no result line, when JAX finds no GPU or any
phase fails.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: Read pairs of the -e phase's dataset (at most; --pairs caps it).
EDIT_PAIRS = 1_000_000
#: Table size of the dense O(U^2) scans (all-pairs at 1M+ uniques would
#: take minutes and measure nothing the bucketed scan does not).
DENSE_UNIQUES = 1 << 16
#: Seconds each process of the four-process leg may take.
CHILD_TIMEOUT = 900
BASES = np.frombuffer(b"ACGT", np.uint8)
READ_LEN = 150
UMI_LEN = 8
#: Fixed-width BCL-Convert header: @<instrument>:<run>:<flowcell>:<lane>:
#: <tile>:<x>:<y>:<UMI> <read>:<filtered>:<control>:<index>
_HDR_HEAD = b"@A00953:88:HCLYKDSX3:1:1101:"
_HDR_TAIL = b":N:0:ATCACGAT"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """[n] non-negative ints -> [n, width] ASCII decimal, zero-padded."""
    out = np.empty((len(v), width), np.uint8)
    v = v.astype(np.int64)
    for p in range(width - 1, -1, -1):
        out[:, p] = v % 10 + ord("0")
        v = v // 10
    return out


def generate_chunks(pairs: int, seed: int, chunk: int = 1 << 18):
    """Read pairs as base-code chunks (umi [k, 8], r1 [k, 150], r2 [k, 150],
    uint8 codes 0-3 in ACGT order), deterministic in ``seed``.

    Molecules (one UMI + one fragment each) get lognormal weights, so
    family sizes are skewed; a quarter of the reads carry one
    substitution inside the 24-nt word (UMI + first 8 nt of each mate)
    and 30% a sequencing error elsewhere in each mate."""
    rng = np.random.default_rng(seed)
    n_mol = max(pairs // 5, 1)
    mol_umi = rng.integers(0, 4, (n_mol, UMI_LEN), dtype=np.uint8)
    mol_r1 = rng.integers(0, 4, (n_mol, READ_LEN), dtype=np.uint8)
    mol_r2 = rng.integers(0, 4, (n_mol, READ_LEN), dtype=np.uint8)
    weight = rng.lognormal(0.0, 1.2, n_mol)
    cdf = np.cumsum(weight)
    cdf /= cdf[-1]
    word_cols = UMI_LEN + 16
    for lo in range(0, pairs, chunk):
        k = min(chunk, pairs - lo)
        mol = np.minimum(np.searchsorted(cdf, rng.random(k)), n_mol - 1)
        umi, r1, r2 = mol_umi[mol], mol_r1[mol], mol_r2[mol]
        rows = np.arange(k)
        # One substitution inside the word for 25% of the reads.
        hit = rng.random(k) < 0.25
        pos = rng.integers(0, word_cols, k)
        shift = rng.integers(1, 4, k).astype(np.uint8)
        for arr, a, b in ((umi, 0, UMI_LEN), (r1, UMI_LEN, UMI_LEN + 8),
                          (r2, UMI_LEN + 8, word_cols)):
            sel = hit & (pos >= a) & (pos < b)
            r, c = rows[sel], pos[sel] - a
            arr[r, c] = (arr[r, c] + shift[sel]) % 4
        # Sequencing errors outside the word.
        for arr in (r1, r2):
            err = rows[rng.random(k) < 0.3]
            c = rng.integers(8, READ_LEN, len(err))
            arr[err, c] = (arr[err, c]
                           + rng.integers(1, 4, len(err)).astype(np.uint8)) % 4
        yield lo, umi, r1, r2


def words_of(umi, r1, r2) -> np.ndarray:
    """The CLI's 24-nt word at -n 24: header UMI + 8 nt of each mate."""
    return np.concatenate([umi, r1[:, :8], r2[:, :8]], axis=1)


def write_dataset(out_dir: str, pairs: int, seed: int,
                  want_words: bool = False):
    """Write ``R1.fastq``/``R2.fastq``; returns (files, words or None)."""
    os.makedirs(out_dir, exist_ok=True)
    files = [os.path.join(out_dir, f"R{m}.fastq") for m in (1, 2)]
    qual_pool = np.frombuffer(b"FFFF:F,FF", np.uint8)
    qrng = np.random.default_rng(seed + 7)
    quals = qual_pool[qrng.integers(0, len(qual_pool), (64, READ_LEN))]
    words = np.empty((pairs, UMI_LEN + 16), np.uint8) if want_words else None
    hlen = len(_HDR_HEAD) + 5 + 1 + 5 + 1 + UMI_LEN + 2 + len(_HDR_TAIL)
    rec_len = hlen + 1 + READ_LEN + 3 + READ_LEN + 1
    handles = [open(f, "wb") for f in files]
    try:
        for lo, umi, r1, r2 in generate_chunks(pairs, seed):
            k = len(umi)
            if words is not None:
                words[lo:lo + k] = words_of(umi, r1, r2)
            idx = np.arange(lo, lo + k, dtype=np.int64)
            x = _digits(10000 + idx // 50000, 5)
            y = _digits(10000 + idx % 50000, 5)
            qsel = quals[qrng.integers(0, len(quals), k)]
            for mate, (fh, seq) in enumerate(zip(handles, (r1, r2)), 1):
                rec = np.empty((k, rec_len), np.uint8)
                c = 0
                for part in (np.frombuffer(_HDR_HEAD, np.uint8), x,
                             np.frombuffer(b":", np.uint8), y,
                             np.frombuffer(b":", np.uint8), BASES[umi],
                             np.frombuffer(f" {mate}".encode(), np.uint8),
                             np.frombuffer(_HDR_TAIL + b"\n", np.uint8),
                             BASES[seq], np.frombuffer(b"\n+\n", np.uint8),
                             qsel, np.frombuffer(b"\n", np.uint8)):
                    w = part.shape[-1]
                    rec[:, c:c + w] = part
                    c += w
                assert c == rec_len
                fh.write(rec.tobytes())
    finally:
        for fh in handles:
            fh.close()
    return files, words


def unique_table(words: np.ndarray) -> np.ndarray:
    from humid_tpu import words as W
    from humid_tpu.ops import unique_words

    uniq, _, _, _ = unique_words(W.pack_words(words), _force_host=True)
    return uniq


# ---------------------------------------------------------------------------
# Outputs
# ---------------------------------------------------------------------------

def compare_outputs(ref_dir: str, our_dir: str) -> list[str]:
    """Problems between two output directories (empty == identical):
    files present in only one of them, and files whose bytes differ."""
    ref = sorted(os.listdir(ref_dir))
    ours = sorted(os.listdir(our_dir))
    problems = [f"only in reference: {f}" for f in ref if f not in ours]
    problems += [f"only in ours: {f}" for f in ours if f not in ref]
    for f in ref:
        if f in ours and not filecmp.cmp(os.path.join(ref_dir, f),
                                         os.path.join(our_dir, f),
                                         shallow=False):
            problems.append(f"differs: {f}")
    return problems


class References:
    """humid_ref runs, started in the background and cached by flags."""

    def __init__(self, exe: str, work: str):
        self.exe = exe
        self.work = work
        self.procs: dict = {}

    def start(self, flags: list[str], files: list[str]) -> None:
        key = (tuple(flags), tuple(files))
        if key in self.procs:
            return
        out = os.path.join(self.work, f"ref{len(self.procs)}")
        os.makedirs(out, exist_ok=True)
        p = subprocess.Popen([self.exe, "-d", out, "-l", os.devnull,
                              *flags, *files],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
        done: dict = {}
        t0 = time.perf_counter()

        def wait():
            done["err"] = p.communicate()[1]
            done["s"] = time.perf_counter() - t0

        th = threading.Thread(target=wait, daemon=True)
        th.start()
        self.procs[key] = (p, out, th, done)

    def get(self, flags: list[str], files: list[str]) -> str:
        self.start(flags, files)
        p, out, th, done = self.procs[(tuple(flags), tuple(files))]
        if th.is_alive() or "shown" not in done:
            th.join()
            check(p.returncode == 0, f"humid_ref {flags} failed: "
                  f"{done['err'].decode()[-500:]}")
            print(f"# humid_ref {' '.join(flags)}: {done['s']:.1f}s "
                  f"(ran beside other references)", flush=True)
            done["shown"] = True
        return out

    def stop(self) -> None:
        for p, _, _, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# Device-engine spies
# ---------------------------------------------------------------------------

#: Device programs of each engine: (module, jitted function).  A spy
#: records the platforms of the arrays each one returns.
DEVICE_PROGRAMS = {
    "unique": ("humid_tpu.ops.unique", "_unique_device_jit"),
    "tile_scan": ("humid_tpu.ops.neighbors", "_all_pairs"),
    "run_sweeps": ("humid_tpu.ops.runs_device", "_runs_eval"),
    "components": ("humid_tpu.cluster.labelprop", "_labelprop"),
    "directional": ("humid_tpu.cluster.directional_device",
                    "_directional_rounds"),
    "edit_verify": ("humid_tpu.ops.edit", "_edit_pairs_impl"),
    "fused_unique": ("humid_tpu.ops.fused", "_fused_unique_jit"),
    "fused_sweep": ("humid_tpu.ops.fused", "_fused_sweep_jit"),
    "fused_labels": ("humid_tpu.ops.fused", "_fused_labels_jit"),
    "mesh_scan": ("humid_tpu.parallel.neighbors", "_bucketed_pairs"),
    "mesh_ring": ("humid_tpu.parallel.neighbors", "_ring_pairs"),
}


@contextlib.contextmanager
def device_spies():
    """Wrap every device program; yields {name: set of platforms} of the
    arrays the programs returned while the context was open."""
    import importlib

    import jax

    seen: dict[str, set] = {}
    saved = []

    def wrap(name, fn):
        def spy(*a, **k):
            out = fn(*a, **k)
            plats = seen.setdefault(name, set())
            for leaf in jax.tree_util.tree_leaves(out):
                if (isinstance(leaf, jax.Array)
                        and not isinstance(leaf, jax.core.Tracer)):
                    plats.update(d.platform for d in leaf.devices())
            return out
        return spy

    for name, (mod_name, attr) in DEVICE_PROGRAMS.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap(name, fn))
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def require_on_gpu(seen: dict, names: list[str], phase: str) -> None:
    for name in names:
        check(name in seen, f"{phase}: device program {name} never ran")
        check(seen[name] == {"gpu"},
              f"{phase}: {name} arrays live on {sorted(seen[name])}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Smoke:
    def __init__(self, work: str, refs: References, card: str):
        self.work = work
        self.refs = refs
        self.card = card
        self.n_cli = 0

    def cli(self, label: str, flags: list[str], files: list[str],
            expect: list[str] = (), engines: tuple = (), **env_kv):
        """Run the CLI in-process under ``env_kv``; byte-compare with
        humid_ref on ``flags``; check the device programs in ``expect``
        ran on the GPU and the recorded engine is one of ``engines``."""
        from humid_tpu import cli
        from humid_tpu.ops import neighbors as nbmod

        out = os.path.join(self.work, f"ours{self.n_cli}")
        self.n_cli += 1
        argv = ["-d", out, "-l", os.path.join(self.work, f"{label}.log"),
                *flags, *files]
        with env(**env_kv), device_spies() as seen:
            t0 = time.perf_counter()
            res = cli.execute(cli.build_parser().parse_args(argv))
            wall = time.perf_counter() - t0
        engine = dict(nbmod.LAST_DECISION)
        times = ", ".join(f"{k}={v:.3f}s"
                          for k, v in res.extra["timings"].items())
        print(f"{label} [{self.card}] {' '.join(flags)} "
              f"{' '.join(f'{k}={v}' for k, v in env_kv.items())}: "
              f"wall={wall:.3f}s; {times}", flush=True)
        print(f"{label}: engine={engine} unique={res.unique} "
              f"clusters={res.clusters} device_programs="
              f"{ {k: sorted(v) for k, v in seen.items()} }", flush=True)
        if engines:
            check(engine.get("strategy") in engines,
                  f"{label}: engine {engine} not in {engines}")
        require_on_gpu(seen, list(expect), label)
        problems = compare_outputs(self.refs.get(flags, files), out)
        check(not problems, f"{label}: {problems}")
        shutil.rmtree(out)
        return res


def engine_phase(uniq: np.ndarray, card: str, dense_uniques: int) -> None:
    """Every device neighbour engine's pair list equals the host runs
    engine's, exactly; prints each engine's time (compile excluded)."""
    from humid_tpu.ops import find_neighbor_pairs

    def timed(table, **kw):
        find_neighbor_pairs(table, 1, word_length=24, **kw)  # compile
        t0 = time.perf_counter()
        a, b = find_neighbor_pairs(table, 1, word_length=24, **kw)
        return a, b, time.perf_counter() - t0

    ra, rb, t = timed(uniq, strategy="runs")
    print(f"engines [{card}] u={len(uniq)} m=1 runs(host): {t:.4f}s "
          f"pairs={len(ra)}", flush=True)
    sub = uniq[:dense_uniques]
    sa, sb, _ = timed(sub, strategy="runs")
    for strategy, impl, table, ref in (
            ("bucketed", "xor", uniq, (ra, rb)),
            ("bucketed", "mxu", uniq, (ra, rb)),
            ("runs_device", None, uniq, (ra, rb)),
            ("dense", "xor", sub, (sa, sb)),
            ("dense", "mxu", sub, (sa, sb))):
        with device_spies() as seen:
            a, b, t = timed(table, strategy=strategy, impl=impl)
        print(f"engines [{card}] u={len(table)} m=1 {strategy}"
              f"{':' + impl if impl else ''}: {t:.4f}s pairs={len(a)}",
              flush=True)
        check(np.array_equal(a, ref[0]) and np.array_equal(b, ref[1]),
              f"engines: {strategy}:{impl} pair list differs from runs")
        require_on_gpu(seen, ["run_sweeps" if strategy == "runs_device"
                              else "tile_scan"], f"engines {strategy}")


def one_card(args, work: str, refs: References, card: str) -> None:
    import jax

    import humid_tpu._backend as B
    from humid_tpu.ops import fused as F

    t0 = time.perf_counter()
    files, words = write_dataset(os.path.join(work, "data"), args.pairs,
                                 args.seed, want_words=True)
    uniq = unique_table(words)
    del words
    print(f"# data: {args.pairs} read pairs, {len(uniq)} unique words, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(len(uniq) >= args.min_uniques,
          f"unique table holds {len(uniq)} < {args.min_uniques} words")
    e_pairs = min(args.pairs, EDIT_PAIRS)
    e_files, _ = write_dataset(os.path.join(work, "edata"), e_pairs,
                               args.seed + 1)
    plain, maxc = ["-s", "-a"], ["-s", "-a", "-x"]
    m2, edit = ["-m", "2", "-s"], ["-e", "-s"]
    for flags, fl in ((plain, files), (maxc, files), (m2, files),
                      (edit, e_files)):
        refs.start(flags, fl)

    stats = jax.devices()[0].memory_stats() or {}
    print(f"# memory [{card}]: bytes_limit={stats.get('bytes_limit')} "
          f"device_bytes_limit={F.device_bytes_limit()}", flush=True)

    engine_phase(uniq, card, DENSE_UNIQUES)

    smoke = Smoke(work, refs, card)
    # Phase 1: default CLI after a fresh calibration.
    os.environ["HUMID_TPU_CALIB_PATH"] = os.path.join(work, "calib.json")
    B._reset_profile_for_tests()
    t0 = time.perf_counter()
    c = B.engine_constants(refresh=True)
    print(f"phase1 [{card}] calibration {time.perf_counter() - t0:.1f}s: "
          f"{json.dumps(c)}", flush=True)
    print(f"phase1 routes: neighbors={B.pick_neighbor_engine()} "
          f"unique_device={B.use_device_engine('unique')} "
          f"cc_device={B.use_device_engine('cc')} "
          f"fused={B.use_fused_pipeline()}", flush=True)
    smoke.cli("phase1", plain, files)
    # Phase 2: the fused route, directional and -x.
    fused = ["fused_unique", "fused_sweep"]
    smoke.cli("phase2", plain, files, expect=fused, engines=("fused",),
              HUMID_TPU_FUSED="1")
    smoke.cli("phase2x", maxc, files, expect=fused + ["fused_labels"],
              engines=("fused",), HUMID_TPU_FUSED="1")
    # Phase 3: phase-wise device engines with -x.
    B._reset_profile_for_tests()
    with env(HUMID_TPU_DEVICE_ENGINE="1"):
        nb = B.pick_neighbor_engine()
    B._reset_profile_for_tests()
    smoke.cli("phase3", maxc, files,
              expect=["unique", "components",
                      "run_sweeps" if nb == "runs_device" else
                      "mesh_scan" if nb == "sharded_bucketed"
                      else "tile_scan"],
              engines=(nb,), HUMID_TPU_DEVICE_ENGINE="1",
              HUMID_TPU_FUSED="0")
    B._reset_profile_for_tests()
    # Phase 4: the tile fallback at -m 2, xor vs mxu.
    for impl in ("xor", "mxu"):
        smoke.cli(f"phase4_{impl}", m2, files, expect=["tile_scan"],
                  engines=("bucketed",), HUMID_TPU_STRATEGY="bucketed",
                  HUMID_TPU_IMPL=impl)
    # Phase 5: -e with the device banded-DP verify.
    smoke.cli("phase5", edit, e_files, expect=["edit_verify"],
              HUMID_TPU_EDIT_VERIFY="device")
    # Phase 6: directional clustering on the device.
    smoke.cli("phase6", plain, files, expect=["directional"],
              HUMID_TPU_CLUSTER="device")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def four_cards(args, work: str, refs: References) -> None:
    """(b) four CLI processes, one per card, joined by a coordinator —
    run before this process touches a card; then (a) one process over a
    4-card mesh: pair lists, node-sharded labels and the sharded CLI."""
    t0 = time.perf_counter()
    files, words = write_dataset(os.path.join(work, "data"), args.pairs,
                                 args.seed, want_words=True)
    print(f"# data: {args.pairs} read pairs, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    plain = ["-s", "-a"]
    refs.start(plain, files)

    port = free_port()
    out = os.path.join(work, "multi")
    procs = []
    t0 = time.perf_counter()
    for i in range(4):
        penv = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "humid_tpu", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "4",
             "--process-id", str(i), "-d", out,
             "-l", os.path.join(work, f"multi{i}.log"), *plain, *files],
            cwd=REPO, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"process {i} failed: "
              f"{log.decode(errors='replace')[-2000:]}")
    print(f"four_processes: 4 processes x 1 card, wall "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    problems = compare_outputs(refs.get(plain, files), out)
    check(not problems, f"four_processes: {problems}")
    shutil.rmtree(out)
    print("four_processes: outputs byte-identical to humid_ref",
          flush=True)

    require_gpus(4)
    card = device_line()
    from humid_tpu.cluster import connected_components_device
    from humid_tpu.ops import find_neighbor_pairs
    from humid_tpu.parallel import (data_mesh,
                                    distributed_components_node_sharded,
                                    sharded_neighbor_pairs)

    uniq = unique_table(words)
    del words
    check(len(uniq) >= args.min_uniques,
          f"unique table holds {len(uniq)} < {args.min_uniques} words")
    ra, rb = find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    mesh = data_mesh()
    for strategy, expect in (("sharded_bucketed", "mesh_scan"),
                             ("sharded", "mesh_scan")):
        with device_spies() as seen:
            t0 = time.perf_counter()
            a, b = find_neighbor_pairs(uniq, 1, word_length=24,
                                       strategy=strategy)
            t = time.perf_counter() - t0
        print(f"mesh [{card}] u={len(uniq)} {strategy}: {t:.4f}s "
              f"(compile included) pairs={len(a)}", flush=True)
        check(np.array_equal(a, ra) and np.array_equal(b, rb),
              f"mesh {strategy}: pair list differs from runs")
        require_on_gpu(seen, [expect], f"mesh {strategy}")
    sub = uniq[:DENSE_UNIQUES]
    sa, sb = find_neighbor_pairs(sub, 1, word_length=24, strategy="runs")
    with device_spies() as seen:
        a, b = sharded_neighbor_pairs(sub, 1, mesh=mesh)
    print(f"mesh [{card}] u={len(sub)} ppermute ring: pairs={len(a)}",
          flush=True)
    check(np.array_equal(a, sa) and np.array_equal(b, sb),
          "mesh ring: pair list differs from runs")
    require_on_gpu(seen, ["mesh_ring"], "mesh ring")
    single = connected_components_device(ra, rb, len(uniq))
    sharded = distributed_components_node_sharded(ra, rb, len(uniq),
                                                  mesh=mesh)
    check(np.array_equal(np.asarray(single), np.asarray(sharded)),
          "node-sharded labels differ from the single-card labels")
    print(f"mesh [{card}] node-sharded labelprop: "
          f"{len(np.unique(single))} components, labels identical",
          flush=True)
    Smoke(work, refs, card).cli("mesh_cli", plain, files,
                                expect=["mesh_scan"],
                                engines=("sharded",),
                                HUMID_TPU_STRATEGY="sharded")


def require_gpus(n: int) -> None:
    import jax

    check(jax.default_backend() == "gpu" and len(jax.devices()) == n,
          f"need {n} GPUs, have {jax.devices()}")


def device_line() -> str:
    import jax

    return f"{jax.devices()[0].device_kind} x{len(jax.devices())}"


def setup() -> str:
    """Build the native extensions and humid_ref; returns humid_ref."""
    import importlib

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "setup.py", "-q", "build_ext",
                    "--inplace"], cwd=REPO, check=True,
                   stdout=subprocess.DEVNULL)
    for mod in ("humid_tpu._hostops", "humid_tpu.cluster._ccluster",
                "humid_tpu.io._cfastqio"):
        importlib.import_module(mod)
    exe = os.path.join(REPO, "baseline", "humid_ref")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe,
                    os.path.join(REPO, "baseline", "humid_ref.cpp"), "-lz"],
                   check=True)
    print(f"# setup: extensions + humid_ref built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return exe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card paths (needs 4 GPUs)")
    p.add_argument("--pairs", type=int, default=4_000_000,
                   help="read pairs to generate (default 4M)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-uniques", type=int, default=1_000_000,
                   help="fail when the unique table is smaller")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    if not args.four:
        import jax

        if jax.default_backend() != "gpu":
            print(f"chip_smoke: no GPU (backend {jax.default_backend()})",
                  file=sys.stderr)
            return 1
    elif shutil.which("nvidia-smi") is None:
        print("chip_smoke: no GPU (nvidia-smi not found)", file=sys.stderr)
        return 1
    exe = setup()
    from humid_tpu._util import configure_compile_cache, nvidia_smi_line

    print(f"# compile cache: {configure_compile_cache()}", flush=True)
    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    refs = References(exe, work)
    t_all = time.perf_counter()
    try:
        if args.four:
            four_cards(args, work, refs)
        else:
            one_card(args, work, refs, device_line())
    finally:
        refs.stop()
        shutil.rmtree(work, ignore_errors=True)

    import jax

    dev = jax.devices()[0]
    print(f"# all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
