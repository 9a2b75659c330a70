"""Device-side pigeonhole runs engine: in-run candidate evaluation on device.

The host ``runs`` engine (ops/neighbors.py::find_neighbor_pairs_runs)
replaces the reference's fuzzy trie walk (findHammingNeighbours,
/root/reference/src/humid.cc:113-130) with pigeonhole sorted-run merge
joins: sort unique words by each of the max_dist+1 contiguous segment
keys, then enumerate only the in-run (equal-key) pairs — O(candidates)
work instead of the O(tile^2) brute-force scans the device ``bucketed``
engine performs.

This module is the device formulation of the SAME candidate structure.
The insight that makes it vectorize:

  After sorting by segment key, every in-run candidate pair is a pair of
  sorted positions (i, i+d) with d <= run_len-1, and (i, i+d) lie in the
  same run IFF their segment keys are equal IFF the segment bits of
  rows[i] XOR rows[i+d] are all zero — a predicate of the very XOR the
  Hamming evaluation needs anyway.

So the device program needs NO run-id plumbing and NO gather: for each
offset d in 1..d_max it evaluates the whole table against its d-shifted
self (one vectorized XOR + 2-bit collapse + popcount sweep), masks by
in-run-ness and distance, and returns the match masks as packed bitmaps
(U/32 uint32 words per offset — 8x smaller than bool over PCIe).  d_max is the longest small run minus one, so the total
work is U * d_max evaluations ~ O(candidates) when runs are short (the
typical case: most runs are length 1-3).  Runs longer than ``run_cap``
fall back to the caller's big-run tile scan, exactly like the host
engine.

Host-side cost stays the parallel radix sort (~21 ns/row) plus a
per-partition permute; device transfers are 4*w bytes/row per partition
up and U*d_max/8 bytes down.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .hamming import MASK_LO


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def segment_lane_masks(word_length: int, n_seg: int, w: int) -> np.ndarray:
    """[n_seg, w] uint32 — per-lane bit masks of each pigeonhole segment.

    Lane l of a packed word holds bases 16l..16l+15, base b at bits
    30-2*(b % 16) .. 31-2*(b % 16) (big-endian within the lane, matching
    words.pack_words and _segment_run_ids' word64 layout).
    """
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    masks = np.zeros((n_seg, w), np.uint32)
    for s in range(n_seg):
        for b in range(bounds[s], bounds[s + 1]):
            lane, pos = divmod(b, 16)
            masks[s, lane] |= np.uint32(0b11 << (30 - 2 * pos))
    return masks


@functools.partial(
    jax.jit, static_argnames=("d_max", "n_seg", "w", "with_owned"))
def _runs_eval(packed, orders, seg_masks, owned, u, max_dist, *,
               d_max: int, n_seg: int, w: int, with_owned: bool):
    """Offset-shift in-run Hamming evaluation.

    packed: [N, w] uint32 — the (padded) unique table in its native
      ascending order.  Partition 0's segment key is the word PREFIX, so
      its sorted order is the identity and the table is used as-is.
    orders: [n_seg-1, N] int32 — sorted orders of partitions 1..m; the
      device gathers the permuted rows itself (HBM-local, ~free) so the
      host ships 4 bytes/row/partition instead of 4*w.
    seg_masks: [n_seg, w] uint32 — segment bit masks (lane layout).
    owned: [n_seg, N] uint8 (or dummy) — 1 where this host shard owns the
      run at that sorted position (with_owned=False ignores it).
    u: valid row count.  max_dist: distance threshold.

    Returns [n_seg, d_max, N/32] uint32 packed match bitmaps: bit k of
    word j of (p, d-1) set iff sorted positions (i, i+d) of partition p
    with i = 32*j + k are an in-run pair within max_dist.
    """
    n = packed.shape[0]
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    iota = jnp.arange(n, dtype=jnp.int32)
    outs = []
    for p in range(n_seg):
        r = packed if p == 0 else packed[orders[p - 1]]
        mask_p = seg_masks[p][None, :]
        per_d = []
        for d in range(1, d_max + 1):
            shifted = jnp.concatenate(
                [r[d:], jnp.zeros((d, w), r.dtype)], axis=0)
            z = r ^ shifted
            in_run = ((z & mask_p) == 0).all(axis=1)
            m = (z | (z >> jnp.uint32(1))) & MASK_LO
            dist = jax.lax.population_count(m).sum(
                axis=-1).astype(jnp.int32)
            match = in_run & (dist <= max_dist) & (iota < u - d)
            if with_owned:
                match &= owned[p] > 0
            bits = (match.reshape(-1, 32).astype(jnp.uint32)
                    * weights).sum(axis=1, dtype=jnp.uint32)
            per_d.append(bits)
        outs.append(jnp.stack(per_d))
    return jnp.stack(outs)


def _quantize_n(n: int) -> int:
    """Pad row counts to a power-of-two-ish quantum (multiple of 128) so
    compiled programs are reused across dataset sizes."""
    p2 = 1 << max(n - 1, 1).bit_length()
    q = 3 * (p2 // 4) if 3 * (p2 // 4) >= n else p2
    return _round_up(max(q, 128), 128)


def _bitmap_positions(bits_np: np.ndarray, n: int) -> np.ndarray:
    """[N/32] uint32 packed bitmap -> sorted positions of set bits (< n)."""
    by = np.ascontiguousarray(bits_np).view(np.uint8)
    # np.unpackbits is MSB-first per byte; uint32 words are little-endian
    # bytes, so bit k of word j lands at byte j*4 + k//8, bit k%8.
    bools = np.unpackbits(by, bitorder="little")[:n]
    return np.flatnonzero(bools)


def runs_device_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    d_cap: int = 8,
    run_cap: int = 2048,
    tile: int = 2048,
    cap_row: int = 16,
    cap_total: int | None = None,
    impl: str | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pigeonhole neighbour search with DEVICE in-run pair evaluation.

    Same output contract and completeness guarantee as
    :func:`humid_tpu.ops.neighbors.find_neighbor_pairs_runs` (each
    unordered pair within ``max_dist`` exactly once, sorted): the host
    computes the per-partition sorted orders and run structure (parallel
    radix sort — partition 0's order is the IDENTITY because the unique
    table is already ascending and its key is the word prefix, so only
    partitions 1..m sort), the device evaluates every in-run candidate
    pair of runs up to length d_max+1 via offset-shift sweeps, runs of
    length (d_max+1, run_cap] are enumerated by the host native path
    (few rows — d_max adapts so they hold <2% of the table), and runs
    longer than ``run_cap`` take the shared big-run device tile
    fallback.  ``shard`` follows the salted run-ownership protocol of
    the host engine (union over parts of the deduplicated outputs ==
    full pair list; all routing decisions are shard-independent).

    Replaces trie.asymmetricHamming (humid.cc:113-130) with the
    candidate enumeration itself running against device sweeps.
    """
    from .neighbors import (
        LAST_DECISION, _big_run_pairs, _combined_u64, _dedupe_pairs,
        _identity_runs, _owned_mask, _partition_runs, _segment_run_ids,
        enumerate_run_pairs, find_neighbor_pairs)

    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    n_seg = max_dist + 1
    keys = _segment_run_ids(packed, word_length, n_seg)
    if not np.all(keys[0][1:] >= keys[0][:-1]):
        # Defensive (mirrors _identity_runs' verified shortcut): the
        # device sweep HARDCODES identity order for partition 0, so a
        # non-ascending unique table — contract violation, but silent
        # wrong pairs if assumed — delegates to the host engine, which
        # sorts every partition.
        from .neighbors import find_neighbor_pairs_runs

        return find_neighbor_pairs_runs(
            packed, max_dist, word_length=word_length, run_cap=run_cap,
            tile=tile, cap_row=cap_row, cap_total=cap_total, impl=impl,
            shard=shard)
    word64 = _combined_u64(packed) if w <= 2 else None

    n = _quantize_n(u)
    # Ship the table FIRST (async): the transfer rides the wire while
    # the host sorts partitions 1..m below.
    packed_pad = np.zeros((n, w), np.uint32)
    packed_pad[:u] = packed
    packed_dev = jax.device_put(packed_pad)
    order_rows = np.zeros((max(n_seg - 1, 1), n), np.int32)
    owned_rows = (np.zeros((n_seg, n), np.uint8) if shard is not None
                  else np.zeros((1, 1), np.uint8))
    orders: list[np.ndarray] = []
    structs: list[tuple] = []
    big_parts: list[tuple] = []
    all_big_rows = [0] * n_seg
    cand_stat = 0
    len_hist = np.zeros(d_cap + 2, np.int64)  # rows by min(len-1, d_cap+1)
    owned_runs: list[np.ndarray | None] = []  # per-run ownership, reused
    for p in range(n_seg):
        if p == 0:
            # Ascending order was verified by the delegation gate above;
            # don't repeat the O(u) compare inside _identity_runs.
            order, run_start, run_len = _identity_runs(
                keys[0], verified=True)
        else:
            order, run_start, run_len = _partition_runs(keys[p])
            order_rows[p - 1, :u] = order
        orders.append(order)
        structs.append((run_start, run_len))
        small = (run_len >= 2) & (run_len <= run_cap)
        sl = run_len[small]
        if len(sl):
            # len_hist stays PRE-ownership so the adaptive d_max (a
            # compiled-program static) is identical on every shard part.
            np.add.at(len_hist, np.minimum(sl - 1, d_cap + 1), sl)
        owned = None
        if shard is not None:
            # One O(runs) key gather + hash per partition, reused by the
            # device mask, the big-run filter, and the mid-run loop.
            owned = _owned_mask(keys[p][order[run_start]], shard,
                                salt_idx=p)
            owned_rows[p, :u] = np.repeat(owned.astype(np.uint8), run_len)
        owned_runs.append(owned)
        # Reported candidates are POST-ownership (this part's work),
        # matching the host engine's accounting.
        slo = run_len[small & owned] if owned is not None else sl
        if len(slo):
            cand_stat += int((slo * (slo - 1) // 2).sum())
        big = run_len > run_cap
        if big.any():
            # Dense-fallback decision must match the host engine's (and
            # be identical across shard parts): PRE-ownership row count.
            all_big_rows[p] = int(run_len[big].sum())
            if owned is not None:
                big &= owned
            if big.any():
                big_parts.append(
                    (p, order, run_start[big].copy(), run_len[big].copy()))

    LAST_DECISION["candidates"] = cand_stat
    if sum(all_big_rows) > u:
        # Degenerate data: same uniform fallback as the host engine.
        return find_neighbor_pairs(
            packed, max_dist, metric="hamming", word_length=word_length,
            strategy="dense", impl=impl, tile=tile, cap_row=cap_row,
            cap_total=cap_total, shard=shard)

    # Adaptive sweep depth: the smallest power-of-two d_max (so distinct
    # datasets share compiled programs) that leaves <2% of the table's
    # rows in longer-than-covered runs; those mid runs go to the host
    # native enumeration, bounding both the sweep count and the d2h
    # bitmap bytes at typical run-length distributions.
    d_max = 1
    while (d_max < d_cap
           and int(len_hist[d_max + 1:].sum()) > max(u // 50, 64)):
        d_max *= 2
    d_max = min(d_max, d_cap)

    bitmaps_fut = _runs_eval(
        packed_dev, jnp.asarray(order_rows), jnp.asarray(
            segment_lane_masks(word_length, n_seg, w)),
        jnp.asarray(owned_rows), jnp.int32(u), jnp.int32(max_dist),
        d_max=d_max, n_seg=n_seg, w=w, with_owned=shard is not None)

    # Mid-length runs on the host while the device sweep is in flight.
    parts_a: list[np.ndarray] = []
    parts_b: list[np.ndarray] = []
    for p in range(n_seg):
        run_start, run_len = structs[p]
        mid = (run_len > d_max + 1) & (run_len <= run_cap)
        if owned_runs[p] is not None:
            mid &= owned_runs[p]
        if mid.any():
            ma, mb, _ = enumerate_run_pairs(
                packed, word64, orders[p], run_start[mid], run_len[mid],
                max_dist)
            parts_a.append(ma)
            parts_b.append(mb)

    bitmaps = np.asarray(jax.device_get(bitmaps_fut))
    for p in range(n_seg):
        order = orders[p]
        for d in range(1, d_max + 1):
            pos = _bitmap_positions(bitmaps[p, d - 1], u)
            if not len(pos):
                continue
            ga = order[pos]
            gb = order[pos + d]
            parts_a.append(np.minimum(ga, gb))
            parts_b.append(np.maximum(ga, gb))

    if big_parts:
        ba, bb = _big_run_pairs(
            packed, big_parts, max_dist, word_length=word_length,
            tile=tile, cap_row=cap_row, cap_total=cap_total, impl=impl)
        parts_a.append(ba)
        parts_b.append(bb)

    if not parts_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    a = np.concatenate(parts_a)
    b = np.concatenate(parts_b)
    return _dedupe_pairs(a, b)
