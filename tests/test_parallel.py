"""Multi-chip sharded paths vs single-device references (8-dev CPU mesh)."""

import numpy as np
import pytest


from humid_tpu import words as W
from humid_tpu.ops import find_neighbor_pairs, unique_words
from humid_tpu.cluster.labelprop import connected_components_device
from humid_tpu.parallel import (
    data_mesh,
    dedup_step,
    distributed_components,
    sharded_neighbor_pairs,
    sharded_neighbor_pairs_bucketed,
)


def _dataset(rng, n, length, pool=6):
    base, _ = _rand(rng, pool, length)
    codes = base[rng.integers(0, pool, n)].copy()
    muts = rng.integers(0, length, n)
    flip = rng.random(n) < 0.7
    codes[np.arange(n)[flip], muts[flip]] = rng.integers(0, 4, flip.sum())
    return codes


def _rand(rng, n, length):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    return codes, W.pack_words(codes)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [0, 1, 2])
def test_sharded_pairs_match_single_device(n_dev, m):
    rng = np.random.default_rng(100 + 10 * n_dev + m)
    codes = _dataset(rng, 600, 20)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_neighbor_pairs(uniq, m, mesh=mesh, cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, m)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_sharded_edit_pairs_match_single_device(n_dev, m):
    """-e on the mesh: the edit ring (banded-Levenshtein tiles over
    ppermute rotations) equals the single-device edit scan."""
    rng = np.random.default_rng(300 + 10 * n_dev + m)
    codes = _dataset(rng, 400, 20)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_neighbor_pairs(uniq, m, mesh=mesh, cap_row=4,
                                    metric="edit", word_length=20)
    a2, b2 = find_neighbor_pairs(uniq, m, metric="edit", word_length=20,
                                 strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_strategy_sharded_edit_dispatch():
    """find_neighbor_pairs(strategy='sharded', metric='edit') routes to
    a mesh engine; sharded_bucketed + edit is rejected."""
    rng = np.random.default_rng(31)
    codes = _dataset(rng, 300, 16)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                 strategy="sharded")
    a2, b2 = find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                 strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    with pytest.raises(ValueError, match="sharded_bucketed"):
        find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                            strategy="sharded_bucketed")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_sharded_shifted_edit_match_single_device(n_dev, m):
    """-e on the mesh, subquadratic (VERDICT r3 #7): the sharded
    (segment, shift) merge joins equal the dense edit scan."""
    from humid_tpu.parallel import sharded_edit_pairs_shifted

    rng = np.random.default_rng(500 + 10 * n_dev + m)
    codes = _dataset(rng, 500, 21, pool=24)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_edit_pairs_shifted(uniq, m, word_length=21,
                                        mesh=mesh, cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, m, metric="edit", word_length=21,
                                 strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_ppermute_ring_wide_words_match_single_device(n_dev, m):
    """The ppermute ring (NCCL on GPUs) at -n 24 with a larger pool and
    odd mesh widths equals the single-device pair list."""
    rng = np.random.default_rng(700 + 10 * n_dev + m)
    codes = _dataset(rng, 800, 24, pool=80)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_neighbor_pairs(uniq, m, mesh=mesh, cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, m, strategy="dense",
                                 word_length=24, impl="xor")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("kw", [{"strategy": "pallas_ring"},
                                {"strategy": "sharded",
                                 "impl": "pallas_ring"}],
                         ids=["strategy", "sharded_impl"])
def test_removed_ring_kernel_rejected(kw):
    """The RDMA ring kernel is gone (ppermute is the ring): asking for it
    is an error, never a silent fallback."""
    rng = np.random.default_rng(19)
    codes = _dataset(rng, 600, 24, pool=60)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    with pytest.raises(ValueError):
        find_neighbor_pairs(uniq, 1, word_length=24, **kw)


def test_sharded_shifted_edit_join_cap_falls_back_to_ring():
    """Degenerate key spaces exceed join_cap: the 'sharded' strategy
    falls back to the dense edit ring and stays correct."""
    from humid_tpu.ops.neighbors import JoinCapExceeded
    from humid_tpu.parallel import sharded_edit_pairs_shifted

    rng = np.random.default_rng(41)
    codes = _dataset(rng, 400, 16, pool=4)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    with pytest.raises(JoinCapExceeded):
        sharded_edit_pairs_shifted(uniq, 1, word_length=16,
                                   mesh=data_mesh(2), join_cap=8)
    a1, b1 = find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                 strategy="sharded", join_cap=8,
                                 runs_threshold=64)
    a2, b2 = find_neighbor_pairs(uniq, 1, metric="edit", word_length=16,
                                 strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_sharded_pairs_overflow_retry():
    rng = np.random.default_rng(7)
    codes = _dataset(rng, 500, 16, pool=3)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(4)
    a1, b1 = sharded_neighbor_pairs(uniq, 2, mesh=mesh, cap_row=2)
    a2, b2 = find_neighbor_pairs(uniq, 2)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_sharded_bucketed_pairs_match_single_device(n_dev, m):
    rng = np.random.default_rng(300 + 10 * n_dev + m)
    codes = _dataset(rng, 700, 20)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_neighbor_pairs_bucketed(
        uniq, m, word_length=20, mesh=mesh, cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, m)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_sharded_bucketed_big_runs_and_retry():
    """Low-entropy words (few distinct segment keys -> giant runs) and a
    tiny cap_row/cap_total force the retry loop on the mesh path."""
    rng = np.random.default_rng(9)
    codes = _dataset(rng, 600, 16, pool=3)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(4)
    a1, b1 = sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=16, mesh=mesh, cap_row=2, cap_total=1 << 8)
    a2, b2 = find_neighbor_pairs(uniq, 2)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_sharded_bucketed_no_matches():
    codes = np.array([[0, 1, 2, 3] * 6, [3, 2, 1, 0] * 6], np.uint8)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a, b = sharded_neighbor_pairs_bucketed(
        uniq, 1, word_length=24, mesh=data_mesh(2))
    assert len(a) == 0 and len(b) == 0


def test_strategy_sharded_bucketed_dispatch():
    """find_neighbor_pairs routes the explicit strategy and the "sharded"
    auto-upgrade through the bucketed mesh path."""
    rng = np.random.default_rng(77)
    codes = _dataset(rng, 800, 24)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    ref_a, ref_b = find_neighbor_pairs(uniq, 1)
    a, b = find_neighbor_pairs(uniq, 1, word_length=24,
                               strategy="sharded_bucketed")
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_array_equal(b, ref_b)
    # "sharded" auto-upgrades above runs_threshold; force with a tiny one.
    a, b = find_neighbor_pairs(uniq, 1, word_length=24, strategy="sharded",
                               runs_threshold=16)
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_array_equal(b, ref_b)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_components(n_dev):
    rng = np.random.default_rng(11)
    num_nodes = 500
    a = rng.integers(0, num_nodes, 300)
    b = rng.integers(0, num_nodes, 300)
    keep = a != b
    a, b = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    mesh = data_mesh(n_dev)
    got = distributed_components(a, b, num_nodes, mesh=mesh)
    ref = connected_components_device(
        a.astype(np.int32), b.astype(np.int32), num_nodes
    )
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_dedup_step_labels_match_host_pipeline(n_dev):
    """Fused multichip step == single-device pairs + components."""
    rng = np.random.default_rng(21 + n_dev)
    codes = _dataset(rng, 800, 24)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    labels, _ = dedup_step(uniq, 1, mesh=mesh, cap_row=4)
    a, b = find_neighbor_pairs(uniq, 1)
    ref = connected_components_device(
        a.astype(np.int32), b.astype(np.int32), len(uniq)
    )
    np.testing.assert_array_equal(labels, ref)


def test_dedup_step_no_edges():
    mesh = data_mesh(2)
    codes = np.array([[0, 1, 2, 3] * 4, [3, 2, 1, 0] * 4], np.uint8)
    packed = W.pack_words(codes)
    labels, _ = dedup_step(packed, 0, mesh=mesh)
    # Distance 0 and distinct words: every word its own component, but
    # dist-0 self pairs are excluded, so labels = identity.
    np.testing.assert_array_equal(labels, np.arange(2, dtype=np.int32))


def test_pipeline_sharded_strategy(tmp_path):
    """The mesh path is reachable through the public pipeline API."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from genfastq import gen_dataset

    from humid_tpu.pipeline import run

    gen_dataset(np.random.default_rng(2), str(tmp_path), n_reads=500)
    files = [str(tmp_path / "file0.fastq")]
    ref = run(files, dir_name=str(tmp_path / "o1"), log_name=os.devnull)
    got = run(files, dir_name=str(tmp_path / "o2"), log_name=os.devnull,
              neighbor_opts={"strategy": "sharded"})
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.clusters == ref.clusters
    got = run(files, dir_name=str(tmp_path / "o3"), log_name=os.devnull,
              neighbor_opts={"strategy": "sharded_bucketed"})
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.clusters == ref.clusters


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_node_sharded_components_match_replicated(n_dev):
    """Node-sharded label propagation (O(U/D) label memory) produces the
    same labels as the replicated variant (VERDICT r1 item 6)."""
    from humid_tpu.parallel.labelprop import (
        distributed_components_node_sharded,
    )

    rng = np.random.default_rng(23)
    num_nodes = 700
    a = rng.integers(0, num_nodes, 500)
    b = rng.integers(0, num_nodes, 500)
    keep = a != b
    a, b = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    mesh = data_mesh(n_dev)
    got = distributed_components_node_sharded(a, b, num_nodes, mesh=mesh)
    ref = connected_components_device(
        a.astype(np.int32), b.astype(np.int32), num_nodes
    )
    np.testing.assert_array_equal(got, ref)


def test_node_sharded_components_edge_cases():
    from humid_tpu.parallel.labelprop import (
        distributed_components_node_sharded,
    )

    mesh = data_mesh(4)
    # no edges
    got = distributed_components_node_sharded(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 37, mesh=mesh)
    np.testing.assert_array_equal(got, np.arange(37))
    # single chain crossing every shard boundary
    n = 64
    a = np.arange(n - 1)
    b = np.arange(1, n)
    got = distributed_components_node_sharded(a, b, n, mesh=mesh)
    np.testing.assert_array_equal(got, np.zeros(n, np.int32))


@pytest.mark.parametrize("n_dev", [16, 32])
def test_dryrun_full_step_wide_mesh(n_dev):
    """The full sharded dedup step (ring search + pmin merge +
    node-sharded labelprop + bucketed mesh search) at mesh widths beyond
    the in-process 8-device cap, via a fresh subprocess."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["DRYRUN_DEVICES"] = str(n_dev)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py")],
        env=env, capture_output=True, timeout=280,
    )
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    assert f"mesh={n_dev}x1".encode() in out.stdout


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_shifted_edit_giant_self_join(n_dev):
    """A shift-0 self-join group larger than one tile exercises the
    upper-triangle tile layout (self groups packed first at identical
    A/B offsets)."""
    from humid_tpu.parallel import sharded_edit_pairs_shifted

    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, size=(700, 21)).astype(np.uint8)
    codes[:, :10] = 1  # shared m=1 segment-0 -> one giant self-join run
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    assert len(uniq) > 512  # spans >1 tile at the 512 edit tile size
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_edit_pairs_shifted(uniq, 1, word_length=21,
                                        mesh=mesh, cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, 1, metric="edit", word_length=21,
                                 strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_sharded_bucketed_degenerate_falls_back_to_ring():
    """One template with scattered substitutions: giant equal-key runs
    cover the table in several partitions, so the bucketed mesh layout
    (which would stack near-full table copies per shard) must take the
    dense-ring fallback — same rule as the host engine's dense route —
    and stay correct."""
    rng = np.random.default_rng(55)
    base = rng.integers(0, 4, 24).astype(np.uint8)
    codes = np.tile(base, (700, 1))
    codes[np.arange(700), rng.integers(0, 24, 700)] = rng.integers(
        0, 4, 700)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(4)
    a1, b1 = sharded_neighbor_pairs_bucketed(
        uniq, 2, word_length=24, mesh=mesh, cap_row=8, run_cap=16)
    a2, b2 = find_neighbor_pairs(uniq, 2, strategy="dense",
                                 word_length=24, impl="xor")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("n_dev", [2, 3])
def test_ppermute_ring_multitile_blocks(n_dev):
    """Per-shard blocks spanning several tiles (a small tile forces the
    multi-tile path) still give the single-device dense pair list."""
    rng = np.random.default_rng(61 + n_dev)
    codes = _dataset(rng, 2500, 24, pool=220)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(n_dev)
    a1, b1 = sharded_neighbor_pairs(uniq, 1, mesh=mesh, cap_row=4,
                                    tile=256)
    a2, b2 = find_neighbor_pairs(uniq, 1, strategy="dense",
                                 word_length=24, impl="xor")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_ppermute_ring_blocks_beyond_one_tile():
    """Random words (few matches) with per-shard blocks larger than the
    default 2048-row tile, on 2 devices."""
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, size=(9500, 24)).astype(np.uint8)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    assert len(uniq) > 2 * 2048
    a1, b1 = sharded_neighbor_pairs(uniq, 1, mesh=data_mesh(2),
                                    cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, 1, strategy="runs",
                                 word_length=24)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_ppermute_ring_cap_row_growth():
    """A row with hundreds of matches at m=2 outgrows the starting
    per-row cap: the ring's retry loop grows cap_row and stays exact."""
    rng = np.random.default_rng(90)
    base = rng.integers(0, 4, 24).astype(np.uint8)
    codes = np.tile(base, (1500, 1))
    p1 = rng.integers(0, 12, 1499)
    p2 = rng.integers(12, 24, 1499)
    rows = np.arange(1, 1500)
    codes[rows, p1] = (base[p1] + 1 + rng.integers(0, 3, 1499)) % 4
    codes[rows, p2] = (base[p2] + 1 + rng.integers(0, 3, 1499)) % 4
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = sharded_neighbor_pairs(uniq, 2, mesh=data_mesh(2),
                                    cap_row=4)
    a2, b2 = find_neighbor_pairs(uniq, 2, strategy="dense",
                                 word_length=24, impl="xor")
    assert np.bincount(np.concatenate([a2, b2])).max() > 4
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_sharded_bucketed_mxu_impl_matches():
    """The bucketed mesh search through the one-hot matmul impl gives
    the same pair list as the xor impl."""
    rng = np.random.default_rng(91)
    codes = _dataset(rng, 3000, 24, pool=300)
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    mesh = data_mesh(3)
    a1, b1 = sharded_neighbor_pairs_bucketed(uniq, 1, word_length=24,
                                             mesh=mesh, impl="mxu")
    a2, b2 = sharded_neighbor_pairs_bucketed(uniq, 1, word_length=24,
                                             mesh=mesh, impl="xor")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
