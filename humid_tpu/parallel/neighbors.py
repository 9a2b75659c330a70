"""Multi-chip neighbour search: ring-rotated block compare under shard_map.

Replaces the reference's sequential per-word trie queries
(``findHammingNeighbours``, humid.cc:113-130) at scale: unique-word
fingerprint blocks are sharded over the ``'data'`` mesh axis; each step of
a ``lax.ppermute`` ring rotation gives every chip a partner shard's block,
against which it runs the same fused tile-scan pair compaction as the
single-chip path (humid_tpu.ops.neighbors.scan_tile_pairs) — XOR+popcount
distance tiles on the VPU, matches compacted into one per-shard device
buffer.

Round-robin coverage: with D shards, steps s = 0..D//2 cover every
unordered block pair exactly once —

* s = 0: local block vs itself, upper triangle only;
* 0 < s < D/2 (and s <= (D-1)/2 for odd D): block pair {me, me+s mod D},
  seen by exactly one of its two shards at s <= D/2;
* s = D/2 (even D): both endpoints see the pair, so only shards with
  index < D/2 emit.

All pairs are emitted as (min, max) global indices, reproducing the
"each unordered pair once" contract of the asymmetric trie search
(humid.cc:118-124).  Pair buffers are fixed-capacity (static shapes for
XLA); true match counts are returned so the driver can detect overflow
and retry with a larger capacity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.neighbors import scan_tile_pairs, _round_up
from .mesh import DATA_AXIS, data_mesh, pad_to_shards

__all__ = ["sharded_neighbor_pairs", "sharded_neighbor_pairs_bucketed",
           "sharded_edit_pairs_shifted"]


def _ring_pairs_local(local, u, max_dist, *, tile: int, cap_row: int,
                      cap_total: int, n_shards: int,
                      metric: str = "hamming", max_dist_static: int = 0,
                      word_length: int | None = None):
    """shard_map body: local [B, W] shard block -> compacted pair buffer.

    ``local`` rows are packed uint32 lanes for Hamming and unpacked
    int32 base codes for the edit metric (the banded-Levenshtein tile
    kernel consumes codes; rotating codes beats unpacking per step).

    Returns (out_a [cap_total], out_b [cap_total], total [1],
    counts [S*nb, 3]) with pairs as (min, max) global indices, -1 padded.
    """
    d = n_shards
    bsh = local.shape[0]
    me = jax.lax.axis_index(DATA_AXIS)
    steps = d // 2 + 1
    t = bsh // tile
    ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    pairs_ij = jnp.asarray(np.stack(
        [ii.ravel(), jj.ravel(), np.ones(t * t)], axis=1
    ).astype(np.int32))
    perm = [(i, (i - 1) % d) for i in range(d)]

    out_a = jnp.full((cap_total,), -1, jnp.int32)
    out_b = jnp.full((cap_total,), -1, jnp.int32)
    state0 = (out_a, out_b, jnp.int32(0))

    def step(carry, s):
        rot, state = carry
        q = (me + s) % d
        u_rows = jnp.clip(u - me * bsh, 0, bsh)
        u_cols = jnp.clip(u - q * bsh, 0, bsh)
        upper_only = s == 0
        if d % 2 == 0:
            enabled = jnp.where(s == d // 2, me < d // 2, True)
        else:
            enabled = jnp.bool_(True)
        state, counts = scan_tile_pairs(
            local, rot, pairs_ij, u_rows, u_cols, max_dist,
            upper_only=upper_only, enabled=enabled,
            row_base=me * bsh, col_base=q * bsh,
            state=state, tile=tile, cap_row=cap_row,
            metric=metric, max_dist_static=max_dist_static,
            word_length=word_length,
        )
        nxt = jax.lax.ppermute(rot, DATA_AXIS, perm) if d > 1 else rot
        return (nxt, state), counts

    (_, (out_a, out_b, total)), counts = jax.lax.scan(
        step, (local, state0), jnp.arange(steps, dtype=jnp.int32)
    )
    return out_a, out_b, total[None], counts.reshape(-1, 3)


@functools.partial(jax.jit, static_argnames=(
    "tile", "cap_row", "cap_total", "n_shards", "mesh", "metric",
    "max_dist_static", "word_length"))
def _ring_pairs(packed, u, max_dist, *, tile: int, cap_row: int,
                cap_total: int, n_shards: int, mesh,
                metric: str = "hamming", max_dist_static: int = 0,
                word_length: int | None = None):
    fn = shard_map(
        functools.partial(
            _ring_pairs_local, tile=tile, cap_row=cap_row,
            cap_total=cap_total, n_shards=n_shards, metric=metric,
            max_dist_static=max_dist_static, word_length=word_length,
        ),
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                   P(DATA_AXIS)),
        check_vma=False,
    )
    return fn(packed, u, max_dist)


def sharded_neighbor_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    mesh=None,
    tile: int = 2048,
    cap_row: int = 16,
    cap_total: int | None = None,
    metric: str = "hamming",
    word_length: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered fingerprint pairs within ``max_dist``, computed on the
    device mesh.  Returns (a, b) int64, a < b, sorted by (a, b) — the same
    contract as :func:`humid_tpu.ops.neighbors.find_neighbor_pairs`.

    ``metric="edit"`` (the ``-e`` flag, humid.cc:140-158) ring-rotates
    UNPACKED code blocks through the banded-Levenshtein tile kernel
    (ops.edit._banded_levenshtein via scan_tile_pairs) — the dense mesh
    analogue of the single-chip edit scan.
    """
    mesh = mesh or data_mesh()
    d = mesh.devices.size
    u, w = packed.shape
    if u <= 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if metric == "edit":
        if word_length is None:
            raise ValueError("edit metric requires word_length")
        from .. import words as W

        # Rotate codes, not packed lanes: the banded DP consumes codes,
        # and unpacking once on host beats re-unpacking every ring step.
        data_host = W.unpack_words(packed, word_length).astype(np.int32)
        tile = min(tile, 512)
    elif metric == "hamming":
        data_host = packed
    else:
        raise ValueError(f"unknown metric {metric!r}")
    tile = min(tile, _round_up(-(-u // d), 256))
    cap_row = min(cap_row, tile)
    data = pad_to_shards(data_host, d, multiple=tile, fill=0)
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    dev = jax.device_put(data, sharding)
    if cap_total is None:
        cap_total = max(1 << 18, 8 * (u // d + 1))
    while True:
        out_a, out_b, totals, counts = _ring_pairs(
            dev, jnp.int32(u), jnp.int32(max_dist),
            tile=tile, cap_row=cap_row, cap_total=cap_total,
            n_shards=d, mesh=mesh, metric=metric,
            max_dist_static=int(max_dist), word_length=word_length,
        )
        counts_h = np.asarray(counts)
        totals_h = np.asarray(totals)
        row_max = int(counts_h[:, 1].max(initial=0))
        if row_max > cap_row:
            cap_row = min(1 << (row_max - 1).bit_length(), tile)
            continue
        if int(totals_h.max(initial=0)) > cap_total:
            cap_total = _round_up(int(totals_h.max()) + 1024, 1 << 14)
            continue
        break
    a = np.asarray(out_a)
    b = np.asarray(out_b)
    keep = a >= 0
    a = a[keep].astype(np.int64)
    b = b[keep].astype(np.int64)
    order = np.lexsort((b, a))
    return a[order], b[order]


def _bucketed_local(pk, ids, pairs, urows, max_dist, *, tile: int,
                    cap_row: int, cap_total: int, metric: str,
                    word_length: int):
    """shard_map body of the bucketed sharded search: the shard's packed
    rows are converted to the tile representation locally (packed lanes
    cross the interconnect, not one-hot floats) and only this shard's
    tile-pair list is scanned, with run-id masking.
    """
    from ..ops.neighbors import _device_rep

    rows = _device_rep(pk, metric, word_length)
    out_a = jnp.full((cap_total,), -1, jnp.int32)
    out_b = jnp.full((cap_total,), -1, jnp.int32)
    t = jnp.bool_(True)
    (out_a, out_b, total), counts = scan_tile_pairs(
        rows, rows, pairs[0], urows[0], urows[0], max_dist,
        upper_only=t, enabled=t,
        row_base=jnp.int32(0), col_base=jnp.int32(0),
        state=(out_a, out_b, jnp.int32(0)),
        tile=tile, cap_row=cap_row, metric=metric,
        max_dist_static=int(0), word_length=word_length,
        row_ids=ids, col_ids=ids,
    )
    return out_a, out_b, total[None], counts


@functools.partial(jax.jit, static_argnames=(
    "tile", "cap_row", "cap_total", "metric", "word_length", "mesh"))
def _bucketed_pairs(packed, ids, pairs, urows, max_dist, *, tile: int,
                    cap_row: int, cap_total: int, metric: str,
                    word_length: int, mesh):
    fn = shard_map(
        functools.partial(
            _bucketed_local, tile=tile, cap_row=cap_row,
            cap_total=cap_total, metric=metric, word_length=word_length,
        ),
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return fn(packed, ids, pairs, urows, max_dist)


def _expand_runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [start, start+len) ranges into one index vector —
    shared ragged-gather helper of both mesh drivers."""
    from .._util import concat_aranges

    return np.repeat(starts, lens) + concat_aranges(lens)


def _snake_assign(weights: np.ndarray, d: int):
    """Heaviest-first boustrophedon deal of work items over ``d`` shards
    (approximates least-loaded greedy without a heap; balance only — the
    scan result is shard-independent).  Returns (rank, shard_of_item)."""
    rank = np.argsort(-weights, kind="stable")
    posn = np.empty(len(weights), np.int64)
    posn[rank] = np.arange(len(weights))
    lane = posn % d
    return rank, np.where((posn // d) % 2 == 0, lane, d - 1 - lane)


def sharded_neighbor_pairs_bucketed(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    mesh=None,
    tile: int = 512,
    cap_row: int = 16,
    cap_total: int | None = None,
    impl: str | None = None,
    run_cap: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic multi-chip neighbour search: pigeonhole runs sharded
    over the device mesh.

    The dense ring (:func:`sharded_neighbor_pairs`) scans all O((U/tile)²)
    tile pairs split D ways.  Here the pigeonhole partitions of the runs
    strategy (a pair within Hamming distance m agrees exactly on one of
    the m+1 contiguous word segments — humid_tpu.ops.neighbors
    find_neighbor_pairs_runs) cut the work first: per partition, words
    are sorted by segment key and only equal-key runs can contain
    matches.  Whole runs are assigned to shards (greedy balance on
    len·(len−1)/2), so every shard scans ONLY the tiles its own runs
    span, with run-id masking — no collective traffic at all during the
    scan, and per-chip work that shrinks with both the pigeonhole filter
    and D.  Cross-partition duplicates are removed host-side.

    Same contract as find_neighbor_pairs: (a, b) int64, a < b, sorted.
    Replaces findHammingNeighbours (humid.cc:113-130) at mesh scale.
    """
    from ..ops.neighbors import (_dedupe_pairs, _pad_pairs,
                                 _partition_runs, _resolve_metric,
                                 _segment_run_ids)

    mesh = mesh or data_mesh()
    d = mesh.devices.size
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    metric, tile = _resolve_metric("hamming", impl, word_length, tile)

    # --- host prep: partitions -> runs -> shard assignment ---
    # Vectorized throughout: at WGS scale there are millions of runs, so
    # per-run Python tuples / np.argmin calls would dominate the search.
    n_seg = max_dist + 1
    keys = _segment_run_ids(packed, word_length, n_seg)
    orders: list[np.ndarray] = []
    part_l, start_l, len_l = [], [], []
    for p in range(n_seg):
        order, run_start, run_len = _partition_runs(keys[p])
        orders.append(order)
        sel = run_len >= 2
        part_l.append(np.full(int(sel.sum()), p, np.int32))
        start_l.append(run_start[sel].astype(np.int64))
        len_l.append(run_len[sel].astype(np.int64))
    part_id = np.concatenate(part_l)
    r_start = np.concatenate(start_l)
    r_len = np.concatenate(len_l)
    n_runs = len(r_len)
    if n_runs == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if int(r_len[r_len > run_cap].sum()) > u:
        # Degenerate data (e.g. one template with scattered
        # substitutions): giant equal-key runs cover most of the table
        # in SEVERAL partitions, so the bucketed layout would stack ~d
        # near-full copies of the table (host + device memory blowup)
        # and serialize the quadratic scan on whichever chips own the
        # giants.  The dense ring does O(U^2/d) uniformly — the same
        # fallback rule as the host runs engine's dense route
        # (find_neighbor_pairs_runs' sum(all_big_rows) > u).
        return sharded_neighbor_pairs(
            packed, max_dist, mesh=mesh, tile=tile, cap_row=cap_row,
            cap_total=cap_total, metric="hamming",
            word_length=word_length)

    # Heaviest-first snake assignment by descending pair count.
    weights = r_len * (r_len - 1) // 2
    rank, shard = _snake_assign(weights, d)

    shard_tot = np.bincount(shard, weights=r_len, minlength=d)
    max_rows = int(shard_tot.max())
    b = min(tile, _round_up(max_rows, 256))
    # Power-of-two tile count per shard: dataset-size changes reuse the
    # compiled program (XLA bakes every array length into the signature).
    nt = -(-_round_up(max_rows, b) // b)
    nt = 1 << (nt - 1).bit_length()
    r_pad = nt * b

    gmaps = np.full((d, r_pad), -1, np.int64)
    rows_all = np.zeros((d * r_pad, w), packed.dtype)
    # Padding rows carry distinct negative ids so they never match.
    rid_all = -np.arange(1, d * r_pad + 1, dtype=np.int32)
    urows = np.zeros(d, np.int32)
    tile_lists: list[np.ndarray] = []
    for si in range(d):
        mine = rank[shard[rank] == si]  # this shard's runs, heaviest first
        l_si = r_len[mine]
        tot = int(l_si.sum())
        urows[si] = tot
        if tot == 0:
            tile_lists.append(np.zeros((0, 2), np.int32))
            continue
        # Row gather: expand each run's sorted-order range; destinations
        # are contiguous because offsets are the cumsum of run lengths.
        src_pos = _expand_runs(r_start[mine], l_si)
        src_part = np.repeat(part_id[mine], l_si)
        idx = np.empty(tot, np.int64)
        for p in range(n_seg):
            m = src_part == p
            if m.any():
                idx[m] = orders[p][src_pos[m]]
        gmaps[si, :tot] = idx
        rows_all[si * r_pad:si * r_pad + tot] = packed[idx]
        rid_all[si * r_pad:si * r_pad + tot] = np.repeat(
            np.arange(len(mine), dtype=np.int32), l_si)
        # Tile pairs: single-tile runs contribute their diagonal tile
        # (the common case, vectorized); runs spanning tiles add their
        # block squares in a loop over that rare subset.
        offs = np.cumsum(l_si) - l_si
        t0 = offs // b
        t1 = (offs + l_si - 1) // b
        tp = {(int(t), int(t)) for t in np.unique(t0[t0 == t1])}
        spans = t0 != t1
        for s0, s1 in zip(t0[spans].tolist(), t1[spans].tolist()):
            for i in range(s0, s1 + 1):
                for j in range(i, s1 + 1):
                    tp.add((i, j))
        tile_lists.append(np.array(sorted(tp), np.int32).reshape(-1, 2))

    t_max = max(len(t) for t in tile_lists)
    t_pad = 1 << max(t_max - 1, 0).bit_length()
    pairs_all = np.zeros((d, t_pad, 3), np.int32)
    for si, tl in enumerate(tile_lists):
        padded = _pad_pairs(tl)
        pairs_all[si, :len(padded)] = padded[:t_pad]

    if cap_total is None:
        cap_total = 1 << max(18, (8 * (u // d + 1)).bit_length())
    cap_row = min(cap_row, b)

    sharding = NamedSharding(mesh, P(DATA_AXIS))
    dev_rows = jax.device_put(rows_all, sharding)
    dev_ids = jax.device_put(rid_all, sharding)
    dev_pairs = jax.device_put(pairs_all, sharding)
    dev_urows = jax.device_put(urows, sharding)

    while True:
        out_a, out_b, totals, counts = _bucketed_pairs(
            dev_rows, dev_ids, dev_pairs, dev_urows, jnp.int32(max_dist),
            tile=b, cap_row=cap_row, cap_total=cap_total, metric=metric,
            word_length=word_length, mesh=mesh,
        )
        counts_h, totals_h = jax.device_get((counts, totals))
        row_max = int(counts_h[:, 1].max(initial=0))
        if row_max > cap_row:
            cap_row = min(1 << (row_max - 1).bit_length(), b)
            continue
        if int(totals_h.max(initial=0)) > cap_total:
            cap_total = 1 << int(totals_h.max()).bit_length()
            continue
        break

    a_h = np.asarray(out_a).reshape(d, cap_total)
    b_h = np.asarray(out_b).reshape(d, cap_total)
    parts_a, parts_b = [], []
    for si in range(d):
        t = int(totals_h[si])
        if not t:
            continue
        ga = gmaps[si][a_h[si, :t]]
        gb = gmaps[si][b_h[si, :t]]
        parts_a.append(np.minimum(ga, gb))
        parts_b.append(np.maximum(ga, gb))
    if not parts_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _dedupe_pairs(np.concatenate(parts_a), np.concatenate(parts_b))


def _cross_local(pka, pkb, ida, idb, pairs, ua, ub, max_dist, *,
                 tile: int, cap_row: int, cap_total: int, metric: str,
                 word_length: int, max_dist_static: int, col_base: int):
    """shard_map body of the cross-stack (A x B) sharded scan: each
    shard's A/B packed rows are unpacked locally, and only its own
    tile-pair list is scanned with group-id masking.  ``col_base`` is a
    static offset >= the A stack length so the (min, max) normalization
    keeps A-side indices below B-side ones (the caller maps each side
    through its own gather map)."""
    from ..ops.neighbors import _device_rep

    rows = _device_rep(pka, metric, word_length)
    cols = _device_rep(pkb, metric, word_length)
    out_a = jnp.full((cap_total,), -1, jnp.int32)
    out_b = jnp.full((cap_total,), -1, jnp.int32)
    t = jnp.bool_(True)
    (out_a, out_b, total), counts = scan_tile_pairs(
        rows, cols, pairs[0], ua[0], ub[0], max_dist,
        upper_only=jnp.bool_(False), enabled=t,
        row_base=jnp.int32(0), col_base=jnp.int32(col_base),
        state=(out_a, out_b, jnp.int32(0)),
        tile=tile, cap_row=cap_row, metric=metric,
        max_dist_static=max_dist_static, word_length=word_length,
        row_ids=ida, col_ids=idb,
    )
    return out_a, out_b, total[None], counts


@functools.partial(jax.jit, static_argnames=(
    "tile", "cap_row", "cap_total", "metric", "word_length",
    "max_dist_static", "col_base", "mesh"))
def _cross_pairs(pka, pkb, ida, idb, pairs, ua, ub, max_dist, *,
                 tile: int, cap_row: int, cap_total: int, metric: str,
                 word_length: int, max_dist_static: int, col_base: int,
                 mesh):
    fn = shard_map(
        functools.partial(
            _cross_local, tile=tile, cap_row=cap_row,
            cap_total=cap_total, metric=metric, word_length=word_length,
            max_dist_static=max_dist_static, col_base=col_base,
        ),
        mesh=mesh,
        in_specs=(P(DATA_AXIS),) * 7 + (P(),),
        out_specs=(P(DATA_AXIS),) * 4,
        check_vma=False,
    )
    return fn(pka, pkb, ida, idb, pairs, ua, ub, max_dist)


def sharded_edit_pairs_shifted(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    mesh=None,
    tile: int = 512,
    cap_row: int = 16,
    cap_total: int | None = None,
    join_cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic multi-chip EDIT-distance neighbour search: the
    (segment, shift) merge joins of the host shifted-segment engine
    (humid_tpu.ops.neighbors.find_edit_pairs_shifted) sharded over the
    device mesh (VERDICT r3 #7).

    Partition lemma with indels: an alignment within m edits leaves one
    of the m+1 contiguous query segments untouched, appearing exactly at
    its position offset by an indel balance d in [-m, m].  For every
    (segment, shift), the equal-key GROUPS of (canonical keys) x
    (shifted keys) hold all candidates; whole groups are assigned to
    shards (heaviest-first snake on |A|x|B|), and each chip runs the
    banded-Levenshtein tile scan over ONLY the cross tiles its groups
    span, with group-id masking — the verification happens in the same
    device pass, no collective traffic during the scan.  Cross-join
    duplicates and self-pairs are removed host-side.

    Same contract as find_neighbor_pairs (a < b int64, sorted).
    Replaces the O(U^2/D) dense mesh edit ring (findEditNeighbours,
    humid.cc:140-158) with work proportional to the candidate count.
    Degenerate key spaces exceeding ``join_cap`` raise
    :class:`humid_tpu.ops.neighbors.JoinCapExceeded` (callers fall back
    to the dense ring).
    """
    from ..ops.neighbors import (JoinCapExceeded, _dedupe_pairs,
                                 _pad_pairs, _segment_keys_at,
                                 _sorted_run_counts)
    from ..ops.unique import _stable_argsort_u64
    from .. import words as W

    mesh = mesh or data_mesh()
    d_sh = mesh.devices.size
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if join_cap is None:
        from .._util import avail_bytes

        join_cap = max(1 << 26, avail_bytes() // 4 // 16)

    n_seg = max_dist + 1
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    codes = np.ascontiguousarray(
        W.unpack_words(packed, word_length).astype(np.uint8))

    # --- host prep: per-(segment, shift) equal-key groups ---
    # Each group is (a_start, a_len) in the canonical sort order and
    # (b_start, b_len) in the shifted sort order; candidates = |A|x|B|.
    ga_ord: list[np.ndarray] = []   # per-join canonical sort order
    gb_ord: list[np.ndarray] = []   # per-join shifted sort order
    g_join: list[np.ndarray] = []   # group -> join index
    g_self: list[np.ndarray] = []   # group is a shift-0 self-join
    g_as, g_al, g_bs, g_bl = [], [], [], []
    n_join = 0
    for s in range(n_seg):
        lo, hi = bounds[s], bounds[s + 1]
        ka = _segment_keys_at(packed, word_length, lo, hi, codes)
        oa = _stable_argsort_u64(ka)
        # Canonical-side run counts depend only on the segment: hoist
        # out of the shift loop (2m redundant O(U) passes otherwise).
        va, ca = _sorted_run_counts(ka[oa])
        for dd in range(-max_dist, max_dist + 1):
            if lo + dd < 0 or hi + dd > word_length:
                continue
            if dd == 0:
                kb, ob = ka, oa
            else:
                kb = _segment_keys_at(packed, word_length, lo + dd,
                                      hi + dd, codes)
                ob = _stable_argsort_u64(kb)
            if dd == 0:
                # Self-join: A and B sides are the SAME sorted order.
                # Candidates = unordered in-run pairs (c*(c-1)/2 — the
                # host engine's _join_size accounting; c^2 would trip
                # the cap ~2x early), and singleton groups contribute
                # only the self-pair, so they are dropped outright
                # instead of padding every shard with the full table.
                need = int((ca * (ca - 1) // 2).sum())
                if need > join_cap:
                    raise JoinCapExceeded(
                        f"sharded shifted-segment join (segment {s}, "
                        f"shift 0) needs {need} candidates (> join_cap="
                        f"{join_cap}); use the dense edit ring")
                a_starts = np.cumsum(ca) - ca
                sel = np.flatnonzero(ca >= 2)
                if not len(sel):
                    continue
                g_as.append(a_starts[sel])
                g_al.append(ca[sel])
                g_bs.append(a_starts[sel])
                g_bl.append(ca[sel])
                g_join.append(np.full(len(sel), n_join, np.int32))
                g_self.append(np.ones(len(sel), bool))
                ga_ord.append(oa)
                gb_ord.append(ob)
                n_join += 1
                continue
            vb, cb = _sorted_run_counts(kb[ob])
            pos = np.searchsorted(va, vb)
            pos_c = np.minimum(pos, max(len(va) - 1, 0))
            m = ((pos < len(va)) & (va[pos_c] == vb) if len(va)
                 else np.zeros(len(vb), bool))
            need = int((ca[pos_c[m]] * cb[m]).sum())
            if need > join_cap:
                raise JoinCapExceeded(
                    f"sharded shifted-segment join (segment {s}, shift "
                    f"{dd}) needs {need} candidates (> join_cap="
                    f"{join_cap}); use the dense edit ring")
            if not m.any():
                continue
            a_starts = np.cumsum(ca) - ca
            b_starts = np.cumsum(cb) - cb
            sel_b = np.flatnonzero(m)
            sel_a = pos[sel_b]
            g_as.append(a_starts[sel_a])
            g_al.append(ca[sel_a])
            g_bs.append(b_starts[sel_b])
            g_bl.append(cb[sel_b])
            g_join.append(np.full(len(sel_b), n_join, np.int32))
            g_self.append(np.zeros(len(sel_b), bool))
            ga_ord.append(oa)
            gb_ord.append(ob)
            n_join += 1
    if not g_as:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    g_as = np.concatenate(g_as)
    g_al = np.concatenate(g_al)
    g_bs = np.concatenate(g_bs)
    g_bl = np.concatenate(g_bl)
    g_join = np.concatenate(g_join)
    g_self = np.concatenate(g_self)
    n_groups = len(g_as)

    # Heaviest-first snake assignment over the true candidate counts
    # (upper triangle for self-joins).
    weights = np.where(g_self, (g_al * (g_al - 1)) // 2, g_al * g_bl)
    rank, shard = _snake_assign(weights, d_sh)

    tile = min(tile, 512)  # edit tiles are VPU-bound; match _resolve_metric
    rows_a_tot = np.bincount(shard, weights=g_al, minlength=d_sh)
    rows_b_tot = np.bincount(shard, weights=g_bl, minlength=d_sh)
    b_a = min(tile, _round_up(max(int(rows_a_tot.max()), 1), 256))
    b_b = min(tile, _round_up(max(int(rows_b_tot.max()), 1), 256))
    b = max(b_a, b_b)
    nt_a = 1 << (max(-(-_round_up(int(rows_a_tot.max()), b) // b), 1)
                 - 1).bit_length()
    nt_b = 1 << (max(-(-_round_up(int(rows_b_tot.max()), b) // b), 1)
                 - 1).bit_length()
    r_pad_a, r_pad_b = nt_a * b, nt_b * b

    gmap_a = np.full((d_sh, r_pad_a), -1, np.int64)
    gmap_b = np.full((d_sh, r_pad_b), -1, np.int64)
    rows_a = np.zeros((d_sh * r_pad_a, w), packed.dtype)
    rows_b = np.zeros((d_sh * r_pad_b, w), packed.dtype)
    # Padding ids: DISTINCT negative ranges per side so A-padding never
    # equals B-padding.
    ida = -np.arange(1, d_sh * r_pad_a + 1, dtype=np.int32)
    idb = -np.arange(d_sh * r_pad_a + 1,
                     d_sh * r_pad_a + d_sh * r_pad_b + 1, dtype=np.int32)
    ua = np.zeros(d_sh, np.int32)
    ub = np.zeros(d_sh, np.int32)
    tile_lists: list[np.ndarray] = []
    for si in range(d_sh):
        mine = rank[shard[rank] == si]
        if not len(mine):
            tile_lists.append(np.zeros((0, 2), np.int32))
            continue
        # Self-join groups FIRST, in the same order on both sides: their
        # al == bl, so the A/B pack offsets advance in lockstep and each
        # self group sits at IDENTICAL offsets — element i < j then
        # implies tile(i) <= tile(j), so scanning only its upper-triangle
        # tile pairs still covers every unordered pair once (~2x fewer
        # tile scans on the heaviest, shift-0, joins).
        mine = np.concatenate([mine[g_self[mine]], mine[~g_self[mine]]])
        selfm = g_self[mine]
        al, bl = g_al[mine], g_bl[mine]
        ta, tb = int(al.sum()), int(bl.sum())
        ua[si], ub[si] = ta, tb
        src_a = _expand_runs(g_as[mine], al)
        src_b = _expand_runs(g_bs[mine], bl)
        jn_a = np.repeat(g_join[mine], al)
        jn_b = np.repeat(g_join[mine], bl)
        idx_a = np.empty(ta, np.int64)
        idx_b = np.empty(tb, np.int64)
        for jn in np.unique(g_join[mine]):
            m = jn_a == jn
            idx_a[m] = ga_ord[jn][src_a[m]]
            m = jn_b == jn
            idx_b[m] = gb_ord[jn][src_b[m]]
        gmap_a[si, :ta] = idx_a
        gmap_b[si, :tb] = idx_b
        rows_a[si * r_pad_a:si * r_pad_a + ta] = packed[idx_a]
        rows_b[si * r_pad_b:si * r_pad_b + tb] = packed[idx_b]
        gids = np.arange(len(mine), dtype=np.int32)
        ida[si * r_pad_a:si * r_pad_a + ta] = np.repeat(gids, al)
        idb[si * r_pad_b:si * r_pad_b + tb] = np.repeat(gids, bl)
        # Cross tiles each group spans: (A tiles) x (B tiles).
        offs_a = np.cumsum(al) - al
        offs_b = np.cumsum(bl) - bl
        ta0, ta1 = offs_a // b, (offs_a + al - 1) // b
        tb0, tb1 = offs_b // b, (offs_b + bl - 1) // b
        one = (ta0 == ta1) & (tb0 == tb1)
        tp = set(zip(ta0[one].tolist(), tb0[one].tolist()))
        for k in np.flatnonzero(~one):
            j0 = int(tb0[k])
            for i in range(int(ta0[k]), int(ta1[k]) + 1):
                # Self groups: upper-triangle tiles only (see layout
                # note above; ta0 == tb0 and ta1 == tb1 for them).
                for j in range(max(j0, i) if selfm[k] else j0,
                               int(tb1[k]) + 1):
                    tp.add((i, j))
        tile_lists.append(np.array(sorted(tp), np.int32).reshape(-1, 2))

    t_max = max(len(t) for t in tile_lists)
    t_pad = 1 << max(t_max - 1, 0).bit_length()
    pairs_all = np.zeros((d_sh, t_pad, 3), np.int32)
    for si, tl in enumerate(tile_lists):
        padded = _pad_pairs(tl)
        pairs_all[si, :len(padded)] = padded[:t_pad]

    if cap_total is None:
        cap_total = 1 << max(18, (8 * (u // d_sh + 1)).bit_length())
    cap_row = min(cap_row, b)

    sharding = NamedSharding(mesh, P(DATA_AXIS))
    dev = [jax.device_put(x, sharding) for x in
           (rows_a, rows_b, ida, idb, pairs_all, ua, ub)]

    while True:
        out_a, out_b, totals, counts = _cross_pairs(
            *dev, jnp.int32(max_dist),
            tile=b, cap_row=cap_row, cap_total=cap_total, metric="edit",
            word_length=word_length, max_dist_static=int(max_dist),
            col_base=r_pad_a, mesh=mesh,
        )
        counts_h, totals_h = jax.device_get((counts, totals))
        row_max = int(counts_h[:, 1].max(initial=0))
        if row_max > cap_row:
            cap_row = min(1 << (row_max - 1).bit_length(), b)
            continue
        if int(totals_h.max(initial=0)) > cap_total:
            cap_total = 1 << int(totals_h.max()).bit_length()
            continue
        break

    a_h = np.asarray(out_a).reshape(d_sh, cap_total)
    b_h = np.asarray(out_b).reshape(d_sh, cap_total)
    parts_a, parts_b = [], []
    for si in range(d_sh):
        t = int(totals_h[si])
        if not t:
            continue
        ga = gmap_a[si][a_h[si, :t]]
        gb = gmap_b[si][b_h[si, :t] - r_pad_a]
        keep = ga != gb  # a word can meet itself under a shifted key
        if keep.any():
            parts_a.append(np.minimum(ga[keep], gb[keep]))
            parts_b.append(np.maximum(ga[keep], gb[keep]))
    if not parts_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _dedupe_pairs(np.concatenate(parts_a), np.concatenate(parts_b))
