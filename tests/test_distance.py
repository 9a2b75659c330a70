"""Device distance blocks vs brute-force references."""

import numpy as np
import pytest

from humid_tpu import words as W
from humid_tpu.ops.hamming import hamming_block_xor, hamming_block_mxu
from humid_tpu.ops.neighbors import find_neighbor_pairs, pairs_to_csr
from humid_tpu.ops.edit import edit_block

from oracle import _levenshtein


def _rand_words(rng, n, length):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    return codes, W.pack_words(codes)


def _brute_pairs(codes, max_dist, dist_fn):
    n = len(codes)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if dist_fn(tuple(codes[i]), tuple(codes[j])) <= max_dist:
                out.append((i, j))
    return out


def _hamming(a, b):
    return sum(x != y for x, y in zip(a, b))


@pytest.mark.parametrize("length", [8, 16, 24, 33])
@pytest.mark.parametrize("m", [0, 1, 2])
def test_hamming_block_xor(length, m):
    rng = np.random.default_rng(length * 10 + m)
    # Draw from a small pool + mutations to guarantee near pairs.
    pool, _ = _rand_words(rng, 8, length)
    idx = rng.integers(0, 8, 160)
    codes = pool[idx].copy()
    muts = rng.integers(0, length, 160)
    flip = rng.random(160) < 0.7
    codes[np.arange(160)[flip], muts[flip]] = rng.integers(0, 4, flip.sum())
    packed = W.pack_words(codes)

    r, c, cnt = hamming_block_xor(
        packed, packed, np.int32(0), np.int32(0), np.int32(m), 4096
    )
    cnt = int(cnt)
    got = sorted(zip(np.asarray(r)[:cnt].tolist(),
                     np.asarray(c)[:cnt].tolist()))
    expected = _brute_pairs(codes, m, _hamming)
    assert got == expected


def test_hamming_block_mxu_matches_xor():
    rng = np.random.default_rng(3)
    length = 24
    pool, _ = _rand_words(rng, 6, length)
    codes = pool[rng.integers(0, 6, 128)].copy()
    muts = rng.integers(0, length, 128)
    codes[np.arange(128), muts] = rng.integers(0, 4, 128)
    packed = W.pack_words(codes)
    r1, c1, n1 = hamming_block_xor(
        packed, packed, np.int32(0), np.int32(0), np.int32(2), 4096
    )
    r2, c2, n2 = hamming_block_mxu(
        packed, packed, np.int32(0), np.int32(0), np.int32(2), 4096, length
    )
    assert int(n1) == int(n2)
    a = sorted(zip(np.asarray(r1)[:int(n1)].tolist(),
                   np.asarray(c1)[:int(n1)].tolist()))
    b = sorted(zip(np.asarray(r2)[:int(n2)].tolist(),
                   np.asarray(c2)[:int(n2)].tolist()))
    assert a == b


@pytest.mark.parametrize("m", [1, 2])
def test_edit_block(m):
    rng = np.random.default_rng(50 + m)
    length = 12
    pool, _ = _rand_words(rng, 5, length)
    codes = pool[rng.integers(0, 5, 96)].copy()
    # random substitutions and "shifts" (simulate indel-like neighbours)
    for i in range(96):
        if rng.random() < 0.5:
            codes[i, rng.integers(0, length)] = rng.integers(0, 4)
        if rng.random() < 0.3:
            codes[i] = np.roll(codes[i], 1)
            codes[i, 0] = rng.integers(0, 4)
    packed = W.pack_words(codes)
    r, c, cnt = edit_block(
        packed, packed, np.int32(0), np.int32(0), m, 4096, length
    )
    cnt = int(cnt)
    got = sorted(zip(np.asarray(r)[:cnt].tolist(),
                     np.asarray(c)[:cnt].tolist()))
    expected = _brute_pairs(codes, m, _levenshtein)
    assert got == expected


def test_find_neighbor_pairs_blocking_and_overflow():
    """Multi-block tiling + tiny capacity (forces the overflow-retry path)
    must agree with a single-block run."""
    rng = np.random.default_rng(9)
    length = 16
    pool, _ = _rand_words(rng, 4, length)
    codes = pool[rng.integers(0, 4, 700)].copy()
    muts = rng.integers(0, length, 700)
    codes[np.arange(700), muts] = rng.integers(0, 4, 700)
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)

    a1, b1 = find_neighbor_pairs(uniq, 1, tile=256, cap_row=2,
                                 cap_total=1 << 12)
    a2, b2 = find_neighbor_pairs(uniq, 1)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    expected = _brute_pairs(W.unpack_words(uniq, length), 1, _hamming)
    assert list(zip(a2.tolist(), b2.tolist())) == expected


def test_pairs_to_csr_sorted_neighbors():
    a = np.array([0, 0, 1, 2], np.int64)
    b = np.array([2, 3, 3, 3], np.int64)
    indptr, indices = pairs_to_csr(a, b, 4)
    assert indptr.tolist() == [0, 2, 3, 5, 8]
    assert indices.tolist() == [2, 3, 3, 0, 3, 0, 1, 2]


def test_find_neighbor_pairs_mxu_impl_matches_xor():
    rng = np.random.default_rng(31)
    length = 24
    pool, _ = _rand_words(rng, 5, length)
    codes = pool[rng.integers(0, 5, 900)].copy()
    muts = rng.integers(0, length, 900)
    codes[np.arange(900), muts] = rng.integers(0, 4, 900)
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = find_neighbor_pairs(uniq, 2, impl="xor", word_length=length)
    a2, b2 = find_neighbor_pairs(uniq, 2, impl="mxu", word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_bucketed_matches_dense(m):
    """Pigeonhole-bucketed search finds exactly the dense pair set."""
    from humid_tpu.ops.neighbors import find_neighbor_pairs_bucketed
    rng = np.random.default_rng(60 + m)
    length = 20
    pool, _ = _rand_words(rng, 12, length)
    codes = pool[rng.integers(0, 12, 1500)].copy()
    # up to m mutations per read so pairs exist at every distance <= m
    for _ in range(m):
        sel = rng.random(1500) < 0.5
        codes[np.flatnonzero(sel), rng.integers(0, length, int(sel.sum()))] = (
            rng.integers(0, 4, int(sel.sum()))
        )
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = find_neighbor_pairs_bucketed(uniq, m, word_length=length)
    a2, b2 = find_neighbor_pairs(uniq, m, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_bucketed_huge_run_spans_tiles():
    """A giant bucket spanning several tiles must still yield all pairs."""
    from humid_tpu.ops.neighbors import find_neighbor_pairs_bucketed
    rng = np.random.default_rng(77)
    length = 16
    # All words share segment 0 (first 8 bases identical) -> one giant
    # bucket in partition 0 crossing tile boundaries (tile=256).
    base = rng.integers(0, 4, 8).astype(np.uint8)
    codes = np.empty((900, length), np.uint8)
    codes[:, :8] = base
    codes[:, 8:] = rng.integers(0, 4, (900, 8))
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = find_neighbor_pairs_bucketed(uniq, 1, word_length=length,
                                          tile=256)
    a2, b2 = find_neighbor_pairs(uniq, 1, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_bucketed_rejects_edit_metric():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (300, 24)).astype(np.uint8)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    with pytest.raises(ValueError, match="hamming"):
        find_neighbor_pairs(uniq, 2, metric="edit", word_length=24,
                            strategy="bucketed")


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("length", [20, 24, 33])
def test_runs_matches_dense(m, length):
    """Sorted-run candidate enumeration finds exactly the dense pair set
    (incl. length 33 -> 3 lanes, the numpy-filter fallback path)."""
    from humid_tpu.ops.neighbors import find_neighbor_pairs_runs
    rng = np.random.default_rng(80 + 7 * m + length)
    pool, _ = _rand_words(rng, 12, length)
    codes = pool[rng.integers(0, 12, 1500)].copy()
    for _ in range(m):
        sel = rng.random(1500) < 0.5
        codes[np.flatnonzero(sel), rng.integers(0, length, int(sel.sum()))] = (
            rng.integers(0, 4, int(sel.sum()))
        )
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = find_neighbor_pairs_runs(uniq, m, word_length=length)
    a2, b2 = find_neighbor_pairs(uniq, m, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("length", [20, 24, 33])
def test_runs_device_matches_dense(m, length):
    """Device offset-shift in-run evaluation (VERDICT r3 #1) finds
    exactly the dense pair set, incl. 3-lane words."""
    from humid_tpu.ops.runs_device import runs_device_pairs
    rng = np.random.default_rng(80 + 7 * m + length)
    pool, _ = _rand_words(rng, 12, length)
    codes = pool[rng.integers(0, 12, 1500)].copy()
    for _ in range(m):
        sel = rng.random(1500) < 0.5
        codes[np.flatnonzero(sel), rng.integers(0, length, int(sel.sum()))] = (
            rng.integers(0, 4, int(sel.sum()))
        )
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = runs_device_pairs(uniq, m, word_length=length)
    a2, b2 = find_neighbor_pairs(uniq, m, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_runs_device_mid_and_big_runs():
    """Runs longer than the device sweep depth split between the host
    mid-run enumeration and the big-run device tile scan; the union
    must still equal the dense pair set."""
    from humid_tpu.ops.runs_device import runs_device_pairs
    rng = np.random.default_rng(93)
    length = 16
    # Mixed run lengths in partition 0: a giant shared prefix for a
    # third of the words (big-run path at run_cap=64), mid prefixes of
    # ~20 (host mid enumeration at d_cap=4), short tail (device sweep).
    base = rng.integers(0, 4, 8).astype(np.uint8)
    mids = rng.integers(0, 4, (12, 8)).astype(np.uint8)
    codes = np.empty((900, length), np.uint8)
    codes[:300, :8] = base
    codes[300:540, :8] = mids[rng.integers(0, 12, 240)]
    codes[540:, :8] = rng.integers(0, 4, (360, 8))
    codes[:, 8:] = rng.integers(0, 4, (900, 8))
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = runs_device_pairs(uniq, 1, word_length=length, d_cap=4,
                               run_cap=64, tile=256)
    a2, b2 = find_neighbor_pairs(uniq, 1, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_runs_big_run_device_fallback():
    """Runs longer than run_cap go through the masked device tile scan;
    the union must still equal the dense pair set."""
    from humid_tpu.ops.neighbors import find_neighbor_pairs_runs
    rng = np.random.default_rng(91)
    length = 16
    # All words share segment 0 -> partition 0 is one giant run; with
    # run_cap below the run length it must take the device path.
    base = rng.integers(0, 4, 8).astype(np.uint8)
    codes = np.empty((900, length), np.uint8)
    codes[:, :8] = base
    codes[:, 8:] = rng.integers(0, 4, (900, 8))
    packed = W.pack_words(codes)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(packed)
    a1, b1 = find_neighbor_pairs_runs(uniq, 1, word_length=length,
                                      run_cap=64, tile=256)
    a2, b2 = find_neighbor_pairs(uniq, 1, strategy="dense",
                                 word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_runs_fallback_enumeration_matches_native():
    """The pure-numpy enumeration fallback equals the native one."""
    from humid_tpu.ops import neighbors as N
    if N._run_pairs_native is None:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(13)
    u = 400
    order = rng.permutation(u).astype(np.int64)
    starts = np.array([0, 7, 30, 100, 399], np.int64)
    lens = np.array([7, 23, 70, 299, 1], np.int64)
    sel = lens >= 2
    starts, lens = starts[sel], lens[sel]
    t_cand = int((lens * (lens - 1) // 2).sum())
    oa = np.empty(t_cand, np.int64)
    ob = np.empty(t_cand, np.int64)
    n_out = N._run_pairs_native(order, starts, lens, oa, ob)
    assert n_out == t_cand
    fa, fb = N._run_pairs_fallback(order, starts, lens)
    na = np.stack([oa[:n_out], ob[:n_out]], 1)
    nf = np.stack([fa, fb], 1)
    np.testing.assert_array_equal(
        na[np.lexsort((na[:, 1], na[:, 0]))],
        nf[np.lexsort((nf[:, 1], nf[:, 0]))])


def test_partition_runs_native_matches_fallback(monkeypatch):
    """_partition_runs' fused native path (unique_u64) and the numpy
    argsort fallback produce the same order + run structure."""
    from humid_tpu.ops import neighbors as N
    if N._unique_u64_native is None:
        pytest.skip("native extension not built")
    rng = np.random.default_rng(7)
    key = rng.integers(0, 50, 3000).astype(np.uint64)  # many duplicates
    o1, rs1, rl1 = N._partition_runs(key)
    monkeypatch.setattr(N, "_unique_u64_native", None)
    o2, rs2, rl2 = N._partition_runs(key)
    np.testing.assert_array_equal(o1, o2)  # both stable sorts
    np.testing.assert_array_equal(rs1, rs2)
    np.testing.assert_array_equal(rl1, rl2)


@pytest.mark.parametrize("strategy", ["dense", "bucketed"])
def test_pallas_impl_rejected(strategy):
    """impl="pallas" (a removed kernel) is an error, never a
    silent fallback to interpret mode or to another impl."""
    rng = np.random.default_rng(41)
    pool, _ = _rand_words(rng, 40, 24)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(pool))
    with pytest.raises(ValueError, match="impl"):
        find_neighbor_pairs(uniq, 1, word_length=24, impl="pallas",
                            strategy=strategy)


@pytest.mark.parametrize("impl", ["xor", "mxu"])
def test_rsel_overflow_ladder(impl, monkeypatch):
    """The row-selection compaction (rsel) under-reports when a tile pair
    has more matched rows than the cap; the retry ladder must detect it
    via counts[:, 2] and converge to the exact pair set.  Forced by a
    tiny starting rsel on data where most rows match (4 big clusters)."""
    from humid_tpu.ops import neighbors as N

    monkeypatch.setattr(N, "_RSEL_START", 2)
    rng = np.random.default_rng(77)
    length = 16
    pool, _ = _rand_words(rng, 4, length)
    codes = pool[rng.integers(0, 4, 600)].copy()
    muts = rng.integers(0, length, 600)
    codes[np.arange(600), muts] = rng.integers(0, 4, 600)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = find_neighbor_pairs(uniq, 2, word_length=length,
                                 impl=impl, strategy="dense", tile=256)
    expected = _brute_pairs(W.unpack_words(uniq, length), 2, _hamming)
    assert list(zip(a1.tolist(), b1.tolist())) == expected


@pytest.mark.parametrize("impl", ["xor", "mxu"])
def test_ksel_overflow_ladder(impl, monkeypatch):
    """The per-row match cap (ksel, the column analogue of rsel)
    under-reports when any row matches more columns than the cap; the
    retry ladder must detect it via counts[:, 1] and converge to the
    exact pair set.  Forced by ksel=1 on data where cluster rows match
    many columns (escalates 1 -> ... -> cap_row)."""
    from humid_tpu.ops import neighbors as N

    monkeypatch.setattr(N, "_KSEL_START", 1)
    rng = np.random.default_rng(78)
    length = 16
    pool, _ = _rand_words(rng, 6, length)
    codes = pool[rng.integers(0, 6, 500)].copy()
    muts = rng.integers(0, length, 500)
    codes[np.arange(500), muts] = rng.integers(0, 4, 500)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = find_neighbor_pairs(uniq, 2, word_length=length,
                                 impl=impl, strategy="dense", tile=256)
    expected = _brute_pairs(W.unpack_words(uniq, length), 2, _hamming)
    assert list(zip(a1.tolist(), b1.tolist())) == expected


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("length", [18, 24, 33])
def test_edit_shifted_matches_dense(m, length):
    """Shifted-segment edit candidate generation + banded verify equals
    the dense edit pair set (VERDICT r1 item 8), incl. 3-lane words."""
    from humid_tpu.ops.neighbors import find_edit_pairs_shifted
    rng = np.random.default_rng(300 + 10 * m + length)
    pool, _ = _rand_words(rng, 25, length)
    codes = pool[rng.integers(0, 25, 900)].copy()
    for r in range(900):
        op = int(rng.integers(0, 3))
        if op == 1:
            for _ in range(int(rng.integers(1, m + 1))):
                codes[r, int(rng.integers(0, length))] = rng.integers(0, 4)
        elif op == 2:  # simulated indel: shift tail, random head fill
            d = int(rng.integers(1, m + 1))
            codes[r, d:] = codes[r, :length - d]
            codes[r, :d] = rng.integers(0, 4, d)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = find_edit_pairs_shifted(uniq, m, word_length=length)
    a2, b2 = find_neighbor_pairs(uniq, m, metric="edit",
                                 word_length=length, strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_edit_auto_uses_shifted_above_threshold():
    """metric='edit' auto strategy dispatches to the shifted-segment
    path above runs_threshold and agrees with dense."""
    rng = np.random.default_rng(71)
    length = 24
    pool, _ = _rand_words(rng, 600, length)
    codes = pool[rng.integers(0, 600, 6000)].copy()
    sel = rng.random(6000) < 0.4
    codes[np.flatnonzero(sel), rng.integers(0, length, int(sel.sum()))] = (
        rng.integers(0, 4, int(sel.sum()))
    )
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    assert len(uniq) > 2048
    a1, b1 = find_neighbor_pairs(uniq, 1, metric="edit",
                                 word_length=length)  # auto
    a2, b2 = find_neighbor_pairs(uniq, 1, metric="edit",
                                 word_length=length, strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("length", [24, 33])
def test_edit_device_verify_matches_native(m, length, monkeypatch):
    """The device pairwise banded-Levenshtein verify
    (HUMID_TPU_EDIT_VERIFY=device) keeps exactly the pairs the native
    host filter keeps, in the same order — incl. 3-lane words."""
    from humid_tpu.ops.neighbors import find_edit_pairs_shifted
    rng = np.random.default_rng(4000 + m)
    pool, _ = _rand_words(rng, 20, length)
    codes = pool[rng.integers(0, 20, 700)].copy()
    for r in range(700):
        op = int(rng.integers(0, 3))
        if op == 1:
            codes[r, int(rng.integers(0, length))] = rng.integers(0, 4)
        elif op == 2:
            d = int(rng.integers(1, m + 1))
            codes[r, d:] = codes[r, :length - d]
            codes[r, :d] = rng.integers(0, 4, d)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    a1, b1 = find_edit_pairs_shifted(uniq, m, word_length=length)
    monkeypatch.setenv("HUMID_TPU_EDIT_VERIFY", "device")
    a2, b2 = find_edit_pairs_shifted(uniq, m, word_length=length)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_edit_pairs_verify_direct():
    """edit_pairs_verify agrees with a brute-force Levenshtein on random
    candidate pairs, including non-matching ones."""
    from humid_tpu.ops.edit import edit_pairs_verify

    length = 18
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, (120, length)).astype(np.uint8)
    packed = W.pack_words(codes)
    a = rng.integers(0, 120, 300).astype(np.int64)
    b = rng.integers(0, 120, 300).astype(np.int64)
    ka, kb = edit_pairs_verify(packed, a, b, 2, length, batch=128)

    def lev(x, y):
        row = list(range(length + 1))
        for i in range(1, length + 1):
            nrow = [i]
            for j in range(1, length + 1):
                nrow.append(min(row[j - 1] + (x[i - 1] != y[j - 1]),
                                row[j] + 1, nrow[-1] + 1))
            row = nrow
        return row[length]

    exp = [(int(x), int(y)) for x, y in zip(a, b)
           if lev(codes[x], codes[y]) <= 2]
    assert list(zip(ka.tolist(), kb.tolist())) == exp


def test_degenerate_runs_collapse_to_dense():
    """Low-entropy input where every pigeonhole partition holds a giant
    run: the runs strategy collapses to one dense scan (no stacked
    per-partition copies, no int32 overflow) and matches dense exactly."""
    length = 24
    rng = np.random.default_rng(99)
    tpl = rng.integers(0, 4, length).astype(np.uint8)
    codes = np.tile(tpl, (30_000, 1))
    for r in range(len(codes)):
        for _ in range(int(rng.integers(0, 3))):
            codes[r, int(rng.integers(0, length))] = rng.integers(0, 4)
    from humid_tpu.ops import unique_words
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    assert len(uniq) > 2048  # above runs_threshold -> auto picks runs
    a1, b1 = find_neighbor_pairs(uniq, 2, word_length=length,
                                 strategy="runs", impl="xor")
    a2, b2 = find_neighbor_pairs(uniq, 2, word_length=length,
                                 strategy="dense", impl="xor")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)


def test_edit_degenerate_join_falls_back_to_dense():
    """When the shifted-segment joins exceed join_cap (degenerate key
    space), the auto strategy falls back to the dense edit scan instead
    of raising; an explicit strategy='runs' still raises with advice."""
    from humid_tpu.ops import unique_words

    length = 18
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 9).astype(np.uint8)
    codes = np.empty((600, length), np.uint8)
    codes[:, :9] = base                       # identical first segment
    codes[:, 9:] = rng.integers(0, 4, (600, 9))
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    assert len(uniq) > 500
    a1, b1 = find_neighbor_pairs(uniq, 1, metric="edit",
                                 word_length=length, join_cap=64,
                                 runs_threshold=256)
    a2, b2 = find_neighbor_pairs(uniq, 1, metric="edit",
                                 word_length=length, strategy="dense")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    with pytest.raises(ValueError, match="join_cap"):
        find_neighbor_pairs(uniq, 1, metric="edit", word_length=length,
                            strategy="runs", join_cap=64)


def test_identity_runs_guards_unsorted_input():
    """The partition-0 sort skip assumes an ascending key array; a
    permuted input must fall back to the real sort instead of silently
    losing pairs."""
    from humid_tpu.ops.neighbors import _identity_runs, _partition_runs

    key = np.array([5, 3, 3, 9, 1, 3], np.uint64)
    order, starts, lens = _identity_runs(key)
    o2, s2, l2 = _partition_runs(key)
    np.testing.assert_array_equal(order, o2)
    np.testing.assert_array_equal(starts, s2)
    np.testing.assert_array_equal(lens, l2)
    skey = np.sort(key)
    order, starts, lens = _identity_runs(skey)
    np.testing.assert_array_equal(order, np.arange(len(skey)))
    np.testing.assert_array_equal(starts, [0, 1, 4, 5])
    np.testing.assert_array_equal(lens, [1, 3, 1, 1])


def test_runs_device_unsorted_table_delegates_to_host():
    """A non-ascending unique table violates the contract the device
    sweep's identity-order partition 0 hardcodes; runs_device must
    delegate to the (sorting) host engine instead of silently emitting
    wrong pairs."""
    from humid_tpu.ops.runs_device import runs_device_pairs
    from humid_tpu.ops import unique_words

    rng = np.random.default_rng(321)
    pool, _ = _rand_words(rng, 10, 24)
    codes = pool[rng.integers(0, 10, 800)].copy()
    sel = rng.random(800) < 0.5
    codes[np.flatnonzero(sel), rng.integers(0, 24, int(sel.sum()))] = (
        rng.integers(0, 4, int(sel.sum())))
    uniq, _, _, _ = unique_words(W.pack_words(codes))
    perm = rng.permutation(len(uniq))
    shuffled = uniq[perm]
    a1, b1 = runs_device_pairs(shuffled, 1, word_length=24)
    a2, b2 = find_neighbor_pairs(shuffled, 1, strategy="dense",
                                 word_length=24)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
