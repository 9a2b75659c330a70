"""Neighbour-pair search driver.

Replaces the reference's per-word fuzzy trie traversal
(``findHammingNeighbours``/``findEditNeighbours``, humid.cc:113-158) with
ONE fused device program: a ``lax.scan`` over the upper-triangular grid of
B x B fingerprint tiles that, per tile, computes the XOR+popcount (or
banded-Levenshtein) distance matrix, masks hits, and compacts the matching
(row, col) pairs into a single global device buffer with a running offset.
All shapes are static (one XLA compile regardless of input size), padding
rows are masked by index bound inside the kernel, and the pair buffer is
transferred to the host exactly once — the design that keeps both HBM
traffic and host<->device round-trips minimal.

Capacity overflow (per-tile or total) is detected from the returned
counts and retried with a larger static capacity (new compile, rare).

CSR ordering invariant: every node's neighbour list is sorted ascending by
unique-word index.  This equals the reference's neighbour-list order — the
lexicographic outer walk (humid.cc:117) appends all lexicographically
smaller neighbours (discovered earlier) in ascending order, then all larger
neighbours (yielded by the in-order asymmetric trie search) in ascending
order (humid.cc:118-124).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .hamming import MASK_LO
from .edit import _banded_levenshtein, _unpack


class JoinCapExceeded(ValueError):
    """A shifted-segment join needs more candidate pairs than join_cap
    allows (degenerate key space) — the auto strategy falls back to the
    dense edit scan on this, and ONLY this, error."""


#: Engine actually dispatched by the most recent find_neighbor_pairs call
#: in this process ({"strategy": ..., "shard": ..., "candidates": ...});
#: drivers surface it in PipelineResult.extra["engine"] and tests assert
#: the auto decision / host-shard work proportionality.
LAST_DECISION: dict = {}

#: Starting row-selection cap for the device compaction epilogue (see
#: scan_tile_pairs ``rsel``).  The scatter's cost follows the number of
#: elements it is handed, not how many survive the mask, so selecting
#: the <= rsel matched rows per tile pair before scattering shrinks the
#: epilogue ~tile/rsel-fold.  Overflow (a tile pair with more matched
#: rows) is detected via counts[:, 2] and retried with rsel grown to the
#: observed max.  The value (like ``tile`` and _KSEL_START) is not tuned
#: for the H100.
_RSEL_START = 16
#: Starting per-row match cap (column analogue of rsel; compare
#: counts[:, 1]).  Most matched rows in dedup data have 1-2 neighbours
#: within a tile, so the scatter shrinks another cap_row/ksel-fold.
_KSEL_START = 4

#: Hamming tile implementations: "xor" (XOR + popcount on packed lanes)
#: and "mxu" (one-hot bf16 matmul on the tensor cores).
_IMPLS = ("xor", "mxu")
#: find_neighbor_pairs strategies.
_STRATEGIES = ("auto", "runs", "runs_device", "dense", "bucketed",
               "sharded", "sharded_bucketed")


def _note_strategy(strategy: str) -> None:
    LAST_DECISION.clear()
    LAST_DECISION["strategy"] = strategy


def _note_stat(key: str, value) -> None:
    LAST_DECISION[key] = value


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, wrap-around uint64 arithmetic)."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _owned_mask(key: np.ndarray, shard: tuple[int, int],
                salt_idx: int) -> np.ndarray:
    """Host-sharding ownership of pigeonhole runs (VERDICT r2 #3).

    An equal-key run belongs to exactly ONE host, decided by a salted
    hash of the key itself, so every host derives the same owner for the
    same run without any communication: the union of all hosts' partial
    pair lists equals the full pair set, while per-host candidate work
    is ~1/n_parts.  ``salt_idx`` decorrelates the assignment across
    pigeonhole partitions / (segment, shift) joins.
    """
    part, n_parts = shard
    salt = np.uint64(((2 * salt_idx + 1) * 0xD1B54A32D192ED03)
                     & 0xFFFFFFFFFFFFFFFF)
    return (_mix64(key ^ salt) % np.uint64(n_parts)) == np.uint64(part)


def _tile_distance(rows, cols, metric: str, max_dist_static: int,
                   word_length: int | None):
    """[B, Wa] x [B, Wb] -> [B, B] int32 distances (clamped for edit)."""
    if metric == "hamming":
        z = rows[:, None, :] ^ cols[None, :, :]
        m = (z | (z >> 1)) & MASK_LO
        return jax.lax.population_count(m).sum(axis=-1).astype(jnp.int32)
    elif metric == "hamming_mxu":
        # rows/cols are one-hot bf16 [B, 4*L]; #matching bases of a pair is
        # <onehot(a), onehot(b)>, so dist = L - matches.  One matmul per
        # tile on the tensor cores; exact (see hamming_block_mxu).
        matches = jnp.dot(rows, cols.T, preferred_element_type=jnp.float32)
        return (word_length - matches).astype(jnp.int32)
    elif metric == "edit":
        return _banded_levenshtein(rows, cols, max_dist_static, word_length)
    raise ValueError(f"unknown metric {metric!r}")


def onehot_bases(packed, word_length: int):
    """[N, W] uint32 packed fingerprints -> [N, D] one-hot bf16 with D =
    4*L zero-padded up to a multiple of 128 (an aligned contraction
    depth; the padding contributes nothing to match counts)."""
    codes = _unpack(packed, word_length)  # [N, L] int32
    onehot = (codes[:, :, None] ==
              jnp.arange(4, dtype=jnp.int32)[None, None, :])
    oh = onehot.reshape(codes.shape[0], 4 * word_length).astype(
        jnp.bfloat16)
    d = _round_up(4 * word_length, 128)
    if d > 4 * word_length:
        oh = jnp.pad(oh, ((0, 0), (0, d - 4 * word_length)))
    return oh


def scan_tile_pairs(
    row_data,
    col_data,
    pairs_ij,
    u_rows,
    u_cols,
    max_dist,
    upper_only,
    enabled,
    row_base,
    col_base,
    state,
    *,
    tile: int,
    cap_row: int,
    metric: str = "hamming",
    max_dist_static: int = 0,
    word_length: int | None = None,
    row_ids=None,
    col_ids=None,
    rsel: int | None = None,
    ksel: int | None = None,
):
    """Scan over tile pairs, compacting matches into ``state``.

    Match extraction is per-row ``lax.top_k`` over masked column indices
    rather than ``jnp.nonzero`` (which lowers to a whole-tile sort).
    Each row of a tile may contribute at most
    ``cap_row`` matches; the per-tile row maximum is returned so the
    driver can detect truncation and retry with a larger ``cap_row``.

    Args:
      row_data / col_data: [Tr*tile, D] / [Tc*tile, D] padded fingerprint
        representations (packed uint32 lanes, one-hot bf16, or unpacked
        codes, depending on ``metric``).
      pairs_ij: [nb, 3] int32 (tile_i, tile_j, on) — disabled rows (on=0)
        are scanned but emit nothing, letting drivers pad the tile-pair
        list to a bucketed length so nb changes don't recompile.
      row_ids / col_ids: optional [Tr*tile] / [Tc*tile] int32 bucket ids;
        when given, only pairs with equal ids match (the pigeonhole
        candidate filter of the bucketed driver).
      u_rows / u_cols: valid LOCAL row/col counts (padding masked beyond).
      max_dist: distance threshold (traced).
      upper_only: traced bool — keep only global_col > global_row.
      enabled: traced bool — if False, emit nothing (still scans).
      row_base / col_base: traced GLOBAL index offsets of row 0 / col 0.
      state: (out_a [cap_total], out_b [cap_total], offset) carry; writes
        beyond cap_total are dropped (detected via the total offset).
      tile / cap_row: static tile size and per-row match capacity.
      rsel: optional static row-selection cap.  The scatter costs per
        element handed to it, regardless of how many survive masking,
        so compacting the full [tile, cap_row] candidate block per pair
        can dominate the scan.  With ``rsel``, only the <= rsel rows
        that actually matched are gathered (``top_k`` over masked row
        indices) and the scatter shrinks to [rsel, cap_row].  A pair
        whose matched-row count exceeds rsel under-reports — detected
        via counts[:, 2] and retried by the driver with a larger rsel
        (mirrors the cap_row ladder).
      ksel: optional static per-row match cap — the column analogue of
        rsel: only the first ksel of each row's cap_row candidate slots
        are scattered (typical dedup rows match 1-2 columns).  A row
        with more matches under-reports — detected via counts[:, 1] and
        retried with a larger ksel.

    Returns (state', counts [nb, 3]) with counts[:, 0] the TRUE per-tile
    pair count, counts[:, 1] the per-tile max matches-per-row, and
    counts[:, 2] the per-tile matched-row count (compare against rsel).
    The carried offset advances by the WRITTEN count (== true count iff
    no rsel overflow).  Emitted global pairs are normalized to
    (min, max).
    """
    if rsel is not None and rsel >= tile:
        rsel = None  # selection would be a no-op
    if ksel is not None and ksel >= cap_row:
        ksel = None  # slicing would be a no-op
    kk = cap_row if ksel is None else ksel
    iota_r = jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 0)
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 1)
    iota_rk = jax.lax.broadcasted_iota(jnp.int32, (tile, kk), 0)
    iota_k = jax.lax.broadcasted_iota(jnp.int32, (tile, kk), 1)
    w = row_data.shape[1]
    cap_total = state[0].shape[0]

    def _matches_xla(i, j, on, rows, cols):
        dist = _tile_distance(rows, cols, metric, max_dist_static,
                              word_length)
        lr = i * tile + iota_r           # local row index
        lc = j * tile + iota_c           # local col index
        gr = row_base + lr
        gc = col_base + lc
        mask = (dist <= max_dist) & (lr < u_rows) & (lc < u_cols)
        mask &= jnp.where(upper_only, gc > gr, gr != gc)
        mask &= enabled & on
        if row_ids is not None:
            rid = jax.lax.dynamic_slice(row_ids, (i * tile,), (tile,))
            cid = jax.lax.dynamic_slice(col_ids, (j * tile,), (tile,))
            mask &= rid[:, None] == cid[None, :]
        rowcnt = mask.sum(axis=1, dtype=jnp.int32)       # [tile]
        # All matching columns of a row == its top-kk masked indices
        # (kk < cap_row only under the ksel ladder, whose driver retries
        # when any row's true count exceeds it — counts stay true).
        vals = jnp.where(mask, lc, -1)
        topv, _ = jax.lax.top_k(vals, kk)                # [tile, kk]
        return rowcnt, topv

    def body(carry, ij):
        out_a, out_b, off = carry
        i, j = ij[0], ij[1]
        on = ij[2] > 0
        rows = jax.lax.dynamic_slice(row_data, (i * tile, 0), (tile, w))
        cols = jax.lax.dynamic_slice(col_data, (j * tile, 0), (tile, w))
        rowcnt, topv = _matches_xla(i, j, on, rows, cols)
        rowmax = rowcnt.max()
        n = rowcnt.sum()
        matched = rowcnt > 0
        nmatched = matched.sum(dtype=jnp.int32)
        if rsel is not None:
            # Gather the matched rows before expanding cap_row slots:
            # the scatter shrinks tile/rsel-fold (and cap_row/ksel-fold
            # via the kk column slice; clamped rows mean counts[:, 1] >
            # ksel, so the driver discards the launch and retries).
            mrow = jnp.where(matched, iota_rk[:, 0], -1)
            rowselv, _ = jax.lax.top_k(mrow, rsel)       # [rsel], -1 pad
            have = rowselv >= 0
            rs = jnp.where(have, rowselv, 0)
            selcnt = jnp.minimum(
                jnp.where(have, rowcnt[rs], 0), kk)      # [rsel]
            seltv = topv[rs, :kk]                        # [rsel, kk]
            iota_ks = jax.lax.broadcasted_iota(
                jnp.int32, (rsel, kk), 1)
            valid = ((iota_ks < selcnt[:, None]) & (seltv >= 0)
                     & have[:, None])
            roff = off + jnp.cumsum(selcnt) - selcnt
            tgt = jnp.where(valid, roff[:, None] + iota_ks, cap_total)
            ga = row_base + i * tile + jnp.broadcast_to(
                rs[:, None], (rsel, kk))
            gb = col_base + seltv
            written = selcnt.sum()
        else:
            kcnt = jnp.minimum(rowcnt, kk)
            valid = (iota_k < kcnt[:, None]) & (topv[:, :kk] >= 0)
            roff = off + jnp.cumsum(kcnt) - kcnt
            tgt = jnp.where(valid, roff[:, None] + iota_k, cap_total)
            ga = row_base + i * tile + iota_rk
            gb = col_base + topv[:, :kk]                 # already j*tile+lc
            written = kcnt.sum()
        pa = jnp.minimum(ga, gb).astype(jnp.int32)
        pb = jnp.maximum(ga, gb).astype(jnp.int32)
        out_a = out_a.at[tgt.ravel()].set(pa.ravel(), mode="drop")
        out_b = out_b.at[tgt.ravel()].set(pb.ravel(), mode="drop")
        return (out_a, out_b, off + written), jnp.stack(
            [n, rowmax, nmatched])

    return jax.lax.scan(body, state, pairs_ij)


@functools.partial(jax.jit, static_argnames=(
    "tile", "cap_row", "cap_total", "metric", "max_dist_static",
    "word_length", "with_ids", "rsel", "ksel"))
def _all_pairs(
    data, pairs_ij, u, max_dist, *,
    tile: int, cap_row: int, cap_total: int,
    metric: str, max_dist_static: int, word_length: int | None,
    ids=None, with_ids: bool = False, rsel: int | None = None,
    ksel: int | None = None,
):
    out_a = jnp.full((cap_total,), -1, jnp.int32)
    out_b = jnp.full((cap_total,), -1, jnp.int32)
    state = (out_a, out_b, jnp.int32(0))
    t = jnp.bool_(True)
    (out_a, out_b, total), counts = scan_tile_pairs(
        data, data, pairs_ij, u, u, max_dist,
        upper_only=t, enabled=t,
        row_base=jnp.int32(0), col_base=jnp.int32(0),
        state=state,
        tile=tile, cap_row=cap_row, metric=metric,
        max_dist_static=max_dist_static, word_length=word_length,
        row_ids=ids if with_ids else None,
        col_ids=ids if with_ids else None,
        rsel=rsel, ksel=ksel,
    )
    return out_a, out_b, total, counts


def _pad_pairs(pairs: np.ndarray) -> np.ndarray:
    """[nb, 2] tile pairs -> [nb_pad, 3] with an on-flag column, padded
    with disabled rows to the next power of two so the scan length is
    bucketed (few distinct compiles, <2x wasted tiles)."""
    nb = len(pairs)
    nb_pad = 1 << max(nb - 1, 0).bit_length()
    out = np.zeros((nb_pad, 3), np.int32)
    out[:nb, :2] = pairs
    out[:nb, 2] = 1
    return out


def _check_impl(impl: str | None) -> str | None:
    if impl is not None and impl not in _IMPLS:
        raise ValueError(
            f"unknown Hamming impl {impl!r}; expected one of {_IMPLS}")
    return impl


def _resolve_metric(metric: str, impl: str | None, word_length, tile: int):
    """Pick the device implementation; returns (metric_key, tile)."""
    if metric == "edit":
        if word_length is None:
            raise ValueError("edit metric requires word_length")
        return "edit", min(tile, 512)
    if metric == "hamming":
        impl = _check_impl(impl) or "xor"
        if impl == "mxu":
            if word_length is None:
                raise ValueError("mxu impl requires word_length")
            return "hamming_mxu", tile
        return "hamming", tile
    raise ValueError(f"unknown metric {metric!r}")


def _device_rep(data_host, metric: str, word_length):
    data = jnp.asarray(data_host)
    if metric == "edit":
        return _unpack(data, word_length)
    if metric == "hamming_mxu":
        return onehot_bases(data, word_length)
    return data


def _chunked_run(launch, pairs_raw, tile: int):
    """Generic chunked tile-pair launcher; same (out_a, out_b, total,
    counts) contract as _all_pairs so _extract_with_retry wraps it.

    ``launch(chunk_ij, cr, ct, rsel, ksel) -> (oa, ob, t, c)`` (device
    values).
    Chunking bounds per-launch device memory AND keeps every int32
    quantity (scan offsets, cap_total) under int32 on degenerate
    inputs whose TRUE pair count exceeds 2^31: chunk_nb is derived from
    the tile size so one chunk's worst-case total stays at or under
    2^30 (and _extract_with_retry clamps cap growth there), and the
    host accumulates chunks in int64.  Only the small (total, counts)
    pair is fetched per chunk — the pair buffers stay on device until
    one batched device_get at the end."""
    # The invariant (single-chunk worst-case total <= 2^30) needs
    # tile^2 <= 2^30; larger tiles would make chunk_nb=1 yet let one
    # tile pair alone exceed the cap, turning a dense degenerate input
    # into a hard retry failure instead of a completed run.
    if tile > (1 << 15):
        raise ValueError(
            f"tile {tile} > 32768 breaks the chunked launcher's "
            f"int32-safety invariant (tile^2 must be <= 2^30)")
    chunk_nb = max(1, (1 << 30) // (tile * tile))

    def run(cr, ct):
        outs_a, outs_b, counts = [], [], []
        # Row-selection ladder, handled PER CHUNK: a chunk whose
        # matched-row count exceeds rsel under-reported, so only that
        # chunk relaunches with rsel grown to the observed max (sticky
        # for later chunks — density persists).  Sorted fingerprints
        # concentrate matches in near-diagonal tiles, so most chunks
        # sail through at the cheap starting cap while a dense diagonal
        # chunk escalates alone, never invalidating completed chunks.
        rsel = _RSEL_START if _RSEL_START and _RSEL_START < tile else None
        # Column analogue (per-row match cap, compare counts[:, 1]):
        # typical dedup rows match 1-2 columns, so the scatter shrinks
        # a further cap_row/ksel-fold at the starting cap.
        ksel = _KSEL_START if _KSEL_START and _KSEL_START < cr else None
        for lo in range(0, len(pairs_raw), chunk_nb):
            chunk = _pad_pairs(pairs_raw[lo:lo + chunk_nb, :2])
            while True:
                oa, ob, t, c = launch(chunk, cr, ct, rsel, ksel)
                t, c = jax.device_get((t, c))
                t = int(t)
                retry = False
                if rsel is not None:
                    sel_max = int(c[:, 2].max(initial=0))
                    if sel_max > rsel:
                        grown = 1 << (sel_max - 1).bit_length()
                        rsel = grown if grown < tile else None
                        retry = True
                if ksel is not None:
                    row_max = int(c[:, 1].max(initial=0))
                    if row_max > ksel:
                        grown = 1 << (row_max - 1).bit_length()
                        if grown < cr:
                            ksel = grown
                            retry = True
                        else:
                            ksel = None
                            # row_max > cr needs the OUTER cap_row
                            # ladder anyway — skip the wasted relaunch.
                            retry = row_max <= cr
                if retry:
                    continue
                break
            counts.append(c)
            if t > ct:
                # Chunk overflowed the output buffer: report its true
                # total so the retry loop grows cap_total and reruns.
                return (np.zeros(0, np.int32), np.zeros(0, np.int32), t,
                        np.concatenate(counts))
            if int(c[:, 1].max(initial=0)) > cr:
                # cap_row overflow: let the retry loop grow it before
                # paying for the remaining chunks.
                return (np.zeros(0, np.int32), np.zeros(0, np.int32), 0,
                        np.concatenate(counts))
            outs_a.append(oa[:t])
            outs_b.append(ob[:t])
        fetched = jax.device_get((outs_a, outs_b))
        out_a = (np.concatenate(fetched[0]) if fetched[0]
                 else np.zeros(0, np.int32))
        out_b = (np.concatenate(fetched[1]) if fetched[1]
                 else np.zeros(0, np.int32))
        return out_a, out_b, len(out_a), np.concatenate(counts)

    return run


def _xla_chunked_run(data, pairs_raw, n_rows, max_dist, *, tile,
                     metric, word_length, ids=None):
    """Chunked launcher for the XLA tile scan (see _chunked_run)."""
    rid_dev = jnp.asarray(ids) if ids is not None else None

    def launch(chunk, cr, ct, rsel, ksel):
        return _all_pairs(
            data, jnp.asarray(chunk), jnp.int32(n_rows),
            jnp.int32(max_dist),
            tile=tile, cap_row=cr, cap_total=ct,
            metric=metric, max_dist_static=int(max_dist),
            word_length=word_length, ids=rid_dev,
            with_ids=ids is not None, rsel=rsel, ksel=ksel,
        )

    return _chunked_run(launch, pairs_raw, tile)


def _extract_with_retry(run, u, b, cap_row, cap_total):
    """Run the capacity-retry loop around a scan launcher.

    ``run(cap_row, cap_total)`` -> (out_a, out_b, total, counts).
    (Row-selection overflow never reaches this loop — the chunked
    launchers resolve their rsel ladder per chunk.)
    Returns (a, b) int64 sorted by (a, b).
    """
    while True:
        out_a, out_b, total, counts = run(cap_row, cap_total)
        total_h, counts_h = jax.device_get((total, counts))
        total_h = int(total_h)
        row_max = int(counts_h[:, 1].max(initial=0))
        if row_max > cap_row:
            cap_row = min(1 << (row_max - 1).bit_length(), b)
            continue
        if total_h > cap_total and len(out_a) <= cap_total:
            # Overflow of a single device buffer.  (A chunked launcher
            # returns an already-trimmed concatenation whose length
            # equals total_h — legitimately above one chunk's cap_total
            # — and signals a real chunk overflow with empty buffers
            # instead.)  Growth clamps at 2^30, the chunked launchers'
            # worst-case single-chunk total: an int32-safe ceiling.
            grown = min(1 << (total_h + 1024).bit_length(), 1 << 30)
            if grown <= cap_total:
                raise RuntimeError(
                    f"pair buffer overflow at the {1 << 30} cap "
                    f"(total {total_h}) — tile/chunk invariant broken")
            cap_total = grown
            continue
        break
    # Slice on device so only the true pair count crosses the wire, and
    # fetch both buffers in one device_get round trip.
    if isinstance(out_a, np.ndarray):
        a, bb = out_a[:total_h], out_b[:total_h]
    else:
        a, bb = jax.device_get((out_a[:total_h], out_b[:total_h]))
    a = a.astype(np.int64)
    bb = bb.astype(np.int64)
    order = np.lexsort((bb, a))
    return a[order], bb[order]


def find_neighbor_pairs(
    packed: np.ndarray,
    max_dist: int,
    *,
    metric: str = "hamming",
    word_length: int | None = None,
    tile: int = 2048,
    cap_row: int = 16,
    cap_total: int | None = None,
    impl: str | None = None,
    strategy: str = "auto",
    runs_threshold: int = 1 << 11,
    dense_threshold: int = 1 << 17,
    join_cap: int | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered pairs (a, b), a < b, of unique words within
    ``max_dist``.

    Args:
      packed: [U, W] uint32 unique fingerprints in ascending order.
      max_dist: distance threshold (-m flag).
      metric: "hamming" (default) or "edit" (-e flag, Levenshtein).
      impl: Hamming tile implementation — "xor" (XOR + popcount on the
        packed lanes; the default) or "mxu" (one-hot bf16 matmul on the
        tensor cores).  Any other value raises ValueError.
      strategy: "runs" (pigeonhole sorted-run candidate enumeration with
        device fallback for degenerate buckets — the production
        default), "dense" (all U x U device tiles), "bucketed"
        (pigeonhole partitions scanned as masked device tiles),
        "sharded" (search over the local device mesh — the pigeonhole
        bucketed mesh search when it applies, else the ring-rotated
        dense scan, humid_tpu.parallel), "sharded_bucketed" (force the
        bucketed mesh search), or "auto" (runs for Hamming above
        ``runs_threshold`` unique words, dense below).
      shard: optional (part, n_parts) HOST shard.  Each part computes a
        disjoint-by-construction ~1/n_parts slice of the candidate work
        (pigeonhole runs by salted key hash, tile pairs by striping,
        shifted-segment join keys by the same hash); the union of all
        parts' outputs, deduplicated, equals the unsharded pair list.
        Every strategy/fallback decision is made from shard-independent
        global quantities so all parts pick the same engine — required,
        or the per-part slices would not tile the full pair set.  The
        mesh strategies ("sharded*", device-level) ignore ``shard``:
        each host searches its full local-mesh slice (correct after
        dedup, not work-proportional).

    Returns:
      (a, b): int64 arrays with a < b, sorted by (a, b).
    """
    u, w = packed.shape
    if u <= 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    # Env overrides (testing / ops escape hatch), honored here so every
    # driver sees them; explicit arguments win.
    import os as _os

    env_strategy = _os.environ.get("HUMID_TPU_STRATEGY")
    if env_strategy and strategy == "auto":
        strategy = env_strategy
    env_impl = _os.environ.get("HUMID_TPU_IMPL")
    if env_impl and impl is None:
        impl = env_impl

    _check_impl(impl)
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{_STRATEGIES}")
    auto_chosen = strategy == "auto"
    if strategy == "auto":
        if (
            metric == "hamming" and max_dist >= 1
            and word_length is not None and u > runs_threshold
        ):
            # Production engine choice (VERDICT r2 #2): routed by the
            # MEASURED per-unique cost of every engine on this machine
            # (host runs / device bucketed / device run sweeps / local
            # chip mesh — calibrated once per device kind + core count,
            # cached on disk, humid_tpu._backend.pick_neighbor_engine),
            # gated on a co-located chip.  Host shards (multi-host
            # runs) need the SAME engine on every host (each engine
            # partitions the candidate work differently), so drivers
            # broadcast host 0's calibrated decision and pass
            # ``strategy`` explicitly (parallel.pipeline); a bare auto
            # under a shard keeps the host engine, whose decision needs
            # no cross-host agreement.
            if shard is not None:
                strategy = "runs"
            else:
                from .._backend import pick_neighbor_engine

                strategy = pick_neighbor_engine()
        elif (
            max_dist >= 1 and u > runs_threshold
            and word_length is not None
            and (metric == "hamming" or _merge_join_native is not None)
        ):
            strategy = "runs"
        else:
            strategy = "dense"
    _note_strategy(strategy)
    if shard is not None:
        part, n_parts = shard
        if not (0 <= part < n_parts):
            raise ValueError(f"invalid shard {shard!r}")
        if n_parts == 1:
            shard = None
    if shard is not None:
        _note_stat("shard", tuple(shard))
    if strategy == "runs" and metric == "edit":
        try:
            return find_edit_pairs_shifted(
                packed, max_dist, word_length=word_length,
                join_cap=join_cap, shard=shard)
        except JoinCapExceeded:
            if not auto_chosen:
                raise
            # Degenerate key space (shifted-segment joins exceed the
            # memory-scaled cap): dense is slower but always correct,
            # like the reference's own exhaustive walk.  (With a shard,
            # the cap check uses the shard-independent pre-counted join
            # size, so every part reaches this fallback together.)
            strategy = "dense"
            _note_strategy(strategy)
            if shard is not None:
                _note_stat("shard", tuple(shard))
    if strategy == "runs":
        if metric != "hamming":
            raise ValueError(f"runs strategy: unknown metric {metric!r}")
        return find_neighbor_pairs_runs(
            packed, max_dist, word_length=word_length, tile=tile,
            cap_row=cap_row, cap_total=cap_total, impl=impl, shard=shard,
        )
    if strategy == "runs_device":
        if metric != "hamming":
            raise ValueError(
                f"runs_device strategy: unknown metric {metric!r}")
        if word_length is None:
            raise ValueError("runs_device strategy requires word_length")
        from .runs_device import runs_device_pairs

        return runs_device_pairs(
            packed, max_dist, word_length=word_length, tile=tile,
            cap_row=cap_row, cap_total=cap_total, impl=impl, shard=shard,
        )
    if strategy in ("sharded", "sharded_bucketed"):
        if metric == "edit":
            # Unshifted pigeonhole buckets do not bound edit distance,
            # so the bucketed mesh search cannot serve it.
            if strategy == "sharded_bucketed":
                raise ValueError(
                    "sharded_bucketed supports only the hamming metric "
                    "(pigeonhole segments do not bound edit distance); "
                    "use strategy='sharded'")
            if word_length is None:
                raise ValueError("sharded edit requires word_length")
            # Subquadratic first: the (segment, shift) merge joins
            # sharded over the mesh (VERDICT r3 #7); degenerate key
            # spaces fall back to the dense O(U^2/D) edit ring — the
            # same ladder the host edit engine uses.
            if max_dist >= 1 and u > runs_threshold:
                from ..parallel import sharded_edit_pairs_shifted

                try:
                    return sharded_edit_pairs_shifted(
                        packed, max_dist, word_length=word_length,
                        tile=tile, cap_row=cap_row, cap_total=cap_total,
                        join_cap=join_cap)
                except JoinCapExceeded:
                    pass
            from ..parallel import sharded_neighbor_pairs

            return sharded_neighbor_pairs(
                packed, max_dist, tile=tile, cap_row=cap_row,
                metric="edit", word_length=word_length)
        if metric != "hamming":
            raise ValueError(f"sharded strategy: unknown metric {metric!r}")
        # "sharded" auto-upgrades to the pigeonhole-bucketed mesh search
        # when it applies (subquadratic per-chip work); the dense ring
        # remains for distance 0 / unknown word length / explicit choice.
        if strategy == "sharded_bucketed" or (
            max_dist >= 1 and word_length is not None
            and u > runs_threshold
        ):
            if word_length is None:
                raise ValueError(
                    "sharded_bucketed strategy requires word_length")
            from ..parallel import sharded_neighbor_pairs_bucketed

            return sharded_neighbor_pairs_bucketed(
                packed, max_dist, word_length=word_length, tile=tile,
                cap_row=cap_row, cap_total=cap_total, impl=impl,
            )
        from ..parallel import sharded_neighbor_pairs

        return sharded_neighbor_pairs(packed, max_dist, tile=tile,
                                      cap_row=cap_row)
    if strategy == "bucketed":
        if metric != "hamming":
            raise ValueError(
                "bucketed strategy supports only the hamming metric "
                "(pigeonhole segments do not bound edit distance)"
            )
        return find_neighbor_pairs_bucketed(
            packed, max_dist, word_length=word_length, tile=tile,
            cap_row=cap_row, cap_total=cap_total, impl=impl, shard=shard,
        )

    metric, tile = _resolve_metric(metric, impl, word_length, tile)
    data_host: np.ndarray = packed

    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    if u_pad > u:
        pad = np.zeros((u_pad - u, w), dtype=packed.dtype)
        data_host = np.concatenate([data_host, pad], axis=0)
    t = u_pad // b
    ii, jj = np.triu_indices(t)
    pairs_raw = np.stack([ii, jj], axis=1).astype(np.int32)
    if shard is not None:
        # Each unordered pair lives in exactly one tile pair, so striping
        # the tile-pair list partitions the pair set exactly.
        pairs_raw = pairs_raw[shard[0]::shard[1]]
        _note_stat("candidates", len(pairs_raw) * b * b)
        if not len(pairs_raw):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)

    if cap_total is None:
        # Power of two: distinct dataset sizes reuse compiled programs.
        # Clamped to the chunked launchers' 2^30 int32-safe ceiling (the
        # retry loop grows within the same bound).
        cap_total = min(1 << 30, 1 << max(20, (4 * u - 1).bit_length()))
    cap_row = min(cap_row, b)

    data = _device_rep(data_host, metric, word_length)
    run = _xla_chunked_run(data, pairs_raw, u, max_dist, tile=b,
                           metric=metric, word_length=word_length)
    return _extract_with_retry(run, u, b, cap_row, cap_total)


def _segment_run_ids(packed: np.ndarray, word_length: int, n_seg: int):
    """Per-partition bucket keys: [n_seg][U] uint64 packed segment values.

    For words up to 32 bases (<= 2 lanes) the segment bits are extracted
    directly from a combined uint64 (base b sits at bits 62-2b ..) — no
    per-base unpacking.  Wider words fall back to unpacked codes.
    """
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    u, w = packed.shape
    keys = []
    if w <= 2:
        word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            word64 |= packed[:, 1].astype(np.uint64)
        for s in range(n_seg):
            lo, hi = bounds[s], bounds[s + 1]
            width = 2 * (hi - lo)
            shift = np.uint64(64 - 2 * hi)
            mask = np.uint64((1 << width) - 1)
            keys.append((word64 >> shift) & mask)
        return keys
    from .. import words as W

    codes = W.unpack_words(packed, word_length).astype(np.uint64)
    for s in range(n_seg):
        seg = codes[:, bounds[s]:bounds[s + 1]]
        k = np.zeros(len(packed), np.uint64)
        for c in range(seg.shape[1]):
            k = (k << np.uint64(2)) | seg[:, c]
        keys.append(k)
    return keys


try:
    from .._hostops import run_pairs as _run_pairs_native
    from .._hostops import run_pairs_hamming as _run_pairs_hamming_native
    from .._hostops import unique_u64 as _unique_u64_native
except ImportError:  # pragma: no cover - extension not built
    _run_pairs_native = None
    _run_pairs_hamming_native = None
    _unique_u64_native = None


def _identity_runs(key: np.ndarray, *, verified: bool = False):
    """Run structure of an ALREADY-SORTED key array — partition 0's
    segment key is the word PREFIX and the unique table is ascending,
    so its stable sort order is the identity and the radix sort can be
    skipped (one adjacent-compare pass instead, ~3x cheaper).

    The sortedness assumption is load-bearing (a permuted table would
    silently lose pairs), so it is VERIFIED — one more vectorized
    compare pass, still far cheaper than the sort — and non-ascending
    input falls back to the full sort.  ``verified=True`` skips the
    check when the caller already ran the identical compare (the device
    engine's host-delegation gate, ops/runs_device.py)."""
    n = len(key)
    if not verified and not np.all(key[1:] >= key[:-1]):
        return _partition_runs(key)
    new_run = np.empty(n, bool)
    new_run[0] = True
    np.not_equal(key[1:], key[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, n))
    return np.arange(n, dtype=np.int64), run_start, run_len


def _partition_runs(key: np.ndarray):
    """Sorted order + equal-key run structure for one pigeonhole
    partition.

    Native path: one fused ``unique_u64`` call (parallel radix sort +
    parallel group pass, csrc/hostops.cpp) — the numpy gather/compare/
    flatnonzero run detection it replaces was ~2x the sort itself at
    WGS scale.  Returns (order, run_start, run_len) with run_start
    positions in sorted order.
    """
    n = len(key)
    if _unique_u64_native is not None:
        order = np.empty(n, np.int64)
        group_start = np.empty(n, np.int64)
        counts = np.empty(n, np.int64)
        first_occ = np.empty(n, np.int64)
        inv = np.empty(1, np.int64)
        k = _unique_u64_native(np.ascontiguousarray(key), order,
                               group_start, counts, first_occ, inv, 0)
        return order, group_start[:k], counts[:k]
    from .unique import _stable_argsort_u64

    order = _stable_argsort_u64(key)
    kperm = key[order]
    new_run = np.empty(n, bool)
    new_run[0] = True
    np.not_equal(kperm[1:], kperm[:-1], out=new_run[1:])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, n))
    return order, run_start, run_len


def _run_pairs_fallback(order, starts, lens):
    """Pure-numpy in-run pair enumeration (native extension absent)."""
    outs_a, outs_b = [], []
    for s, l in zip(starts.tolist(), lens.tolist()):
        idx = order[s:s + l]
        ii, jj = np.triu_indices(l, k=1)
        a, b = idx[ii], idx[jj]
        outs_a.append(np.minimum(a, b))
        outs_b.append(np.maximum(a, b))
    if not outs_a:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(outs_a), np.concatenate(outs_b)


def enumerate_run_pairs(packed, word64, order, starts, lens, max_dist):
    """In-run candidate enumeration + Hamming filter for the given
    equal-key runs: fused native path (enumerate+XOR+popcount in one C
    pass) when the word fits 64 bits, native enumeration + vectorized
    host filter otherwise, pure-numpy fallback without the extension.
    Returns (a, b, n_candidates) with a < b NOT yet guaranteed sorted/
    deduped.  Shared by the host runs engine and the runs_device
    mid-run path so the two ladders cannot diverge."""
    t_cand = int((lens * (lens - 1) // 2).sum())
    if t_cand == 0:
        z = np.zeros(0, np.int64)
        return z, z, 0
    ss = np.ascontiguousarray(starts)
    sl = np.ascontiguousarray(lens)
    order = np.ascontiguousarray(order)
    if word64 is not None and _run_pairs_hamming_native is not None:
        oa = np.empty(t_cand, np.int64)
        ob = np.empty(t_cand, np.int64)
        n_out = _run_pairs_hamming_native(word64, order, ss, sl,
                                          int(max_dist), oa, ob)
        return oa[:n_out].copy(), ob[:n_out].copy(), t_cand
    if _run_pairs_native is not None:
        oa = np.empty(t_cand, np.int64)
        ob = np.empty(t_cand, np.int64)
        n_out = _run_pairs_native(order, ss, sl, oa, ob)
        ca, cb = oa[:n_out], ob[:n_out]
    else:
        ca, cb = _run_pairs_fallback(order, ss, sl)
    a, b = _filter_hamming_host(packed, ca, cb, max_dist)
    return a, b, t_cand


def _filter_hamming_host(packed, a, b, max_dist):
    """Keep candidate pairs within ``max_dist`` differing bases
    (vectorized XOR + per-lane popcount)."""
    z = packed[a] ^ packed[b]
    m = (z | (z >> np.uint32(1))) & np.uint32(0x55555555)
    d = np.bitwise_count(m).sum(axis=1, dtype=np.int64)
    keep = d <= max_dist
    return a[keep], b[keep]


def _dedupe_pairs(a: np.ndarray, b: np.ndarray):
    """Sort + dedupe (a, b) pair lists via a fused uint64 key (indices
    are < 2^32).  ~50x faster than np.unique(axis=0), whose row sort
    falls back to void-dtype comparisons."""
    key = (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)
    from .unique import _stable_argsort_u64
    order = _stable_argsort_u64(key)
    sk = key[order]
    if len(sk):
        keep = np.empty(len(sk), bool)
        keep[0] = True
        np.not_equal(sk[1:], sk[:-1], out=keep[1:])
        sk = sk[keep]
    return ((sk >> np.uint64(32)).astype(np.int64),
            (sk & np.uint64(0xFFFFFFFF)).astype(np.int64))


def _combined_u64(packed):
    """[U, W<=2] uint32 lanes -> contiguous uint64 words (big-endian bit
    layout identical to _segment_run_ids)."""
    word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
    if packed.shape[1] == 2:
        word64 |= packed[:, 1].astype(np.uint64)
    return np.ascontiguousarray(word64)


def find_neighbor_pairs_runs(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    run_cap: int = 2048,
    tile: int = 2048,
    cap_row: int = 16,
    cap_total: int | None = None,
    impl: str | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pigeonhole neighbour search via sorted-run candidate enumeration.

    Same guarantee as :func:`find_neighbor_pairs_bucketed` (a pair within
    Hamming distance m agrees exactly on one of the m+1 contiguous word
    segments), but instead of scanning B x B device tiles along the
    bucket diagonal — almost all of which the run-id mask rejects — the
    equal-segment runs produced by the sort are enumerated DIRECTLY:
    each in-run pair is a candidate, checked by host XOR+popcount (fused
    in C, csrc/hostops.cpp).  Expected candidates per partition are
    E[real pairs] + ~U^2/4^(L/(m+1)) random collisions, so for typical
    word lengths this is orders of magnitude less work than tiling.

    Runs longer than ``run_cap`` (degenerate buckets, e.g. low-entropy
    reads) fall back to the device tile kernel, scanning only the tiles
    those runs span with the run-id equality mask.

    ``shard=(part, n_parts)`` keeps only the pigeonhole runs this part
    owns (salted hash of the run key, :func:`_owned_mask`): per-part
    candidate work is ~1/n_parts, and the union over parts of the
    deduplicated outputs equals the full pair list.  Fallback decisions
    stay shard-independent (see find_neighbor_pairs).

    Replaces the reference's per-word fuzzy trie walk
    (findHammingNeighbours, humid.cc:113-130) as the production default.
    """
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    n_seg = max_dist + 1
    keys = _segment_run_ids(packed, word_length, n_seg)
    word64 = _combined_u64(packed) if w <= 2 else None

    parts_a: list[np.ndarray] = [None] * n_seg
    parts_b: list[np.ndarray] = [None] * n_seg
    big_parts: list[tuple] = []
    all_big_rows = [0] * n_seg  # pre-ownership, for the uniform fallback
    cand_stat = [0] * n_seg

    def _one_partition(p):
        # Partition 0 is already in sorted order (prefix key of the
        # ascending unique table): skip its radix sort.
        order, run_start, run_len = (
            _identity_runs(keys[0]) if p == 0
            else _partition_runs(keys[p]))
        small = (run_len >= 2) & (run_len <= run_cap)
        if shard is not None:
            run_keys = keys[p][order[run_start]]
            owned = _owned_mask(run_keys, shard, salt_idx=p)
            small &= owned
        pa, pb, t_cand = enumerate_run_pairs(
            packed, word64, order, run_start[small], run_len[small],
            max_dist)
        cand_stat[p] = t_cand
        parts_a[p] = pa
        parts_b[p] = pb
        if (run_len > run_cap).any():
            big = run_len > run_cap
            # The dense-fallback decision below must be identical on
            # every shard part, so it uses the PRE-ownership row count.
            all_big_rows[p] = int(run_len[big].sum())
            if shard is not None:
                run_keys = keys[p][order[run_start]]
                big &= _owned_mask(run_keys, shard, salt_idx=p)
            if big.any():
                big_parts.append(
                    (p, order, run_start[big].copy(), run_len[big].copy()))

    # Partitions run SEQUENTIALLY when the native extension is present:
    # each _partition_runs call is already OpenMP-parallel across all
    # cores, so an outer thread pool only oversubscribes the cores and
    # forces every fresh pool thread to fault in its own thread_local
    # sort arenas (measured 2-5x slower than serial at 30M reads).  The
    # pure-numpy fallback is single-threaded per partition, so there the
    # pool genuinely overlaps work.
    if _unique_u64_native is None and n_seg > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n_seg) as ex:
            list(ex.map(_one_partition, range(n_seg)))
    else:
        for p in range(n_seg):
            _one_partition(p)

    _note_stat("candidates", sum(cand_stat))
    if sum(all_big_rows) > u:
        # Degenerate data (e.g. one template with scattered
        # substitutions): the giant runs cover most of the table in
        # SEVERAL partitions, so the stacked per-partition scan
        # would evaluate every candidate once per partition.  One
        # dense upper-triangle scan finds each pair exactly once
        # and subsumes the small-run pairs too.  (The row count is
        # shard-independent so every part falls back together.)
        return find_neighbor_pairs(
            packed, max_dist, metric="hamming",
            word_length=word_length, strategy="dense", impl=impl,
            tile=tile, cap_row=cap_row, cap_total=cap_total, shard=shard)
    if big_parts:
        ba, bb = _big_run_pairs(
            packed, big_parts, max_dist, word_length=word_length,
            tile=tile, cap_row=cap_row, cap_total=cap_total, impl=impl)
        parts_a.append(ba)
        parts_b.append(bb)

    a = np.concatenate([x for x in parts_a if x is not None])
    b = np.concatenate([x for x in parts_b if x is not None])
    if not len(a):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _dedupe_pairs(a, b)


def _big_run_pairs(packed, big_parts, max_dist, *, word_length, tile,
                   cap_row, cap_total, impl):
    """Device tile scan restricted to oversized bucket runs.

    For each (partition, order, big_run_starts, big_run_lens), the
    partition's permuted rows are stacked; ONLY rows inside big runs get
    a matchable (positive) run id — everything else carries a distinct
    negative id — and only the tiles those runs span are scanned.
    """
    u, w = packed.shape
    metric, tile = _resolve_metric("hamming", impl, word_length, tile)
    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    t = u_pad // b

    datas, rids, pair_lists, orders = [], [], [], []
    total_big = 0
    for pi, (p, order, rs, rl) in enumerate(big_parts):
        dperm = packed[order]
        if u_pad > u:
            dperm = np.concatenate(
                [dperm, np.zeros((u_pad - u, w), dperm.dtype)])
        rid = -np.arange(1, u_pad + 1, dtype=np.int64) - pi * (u_pad + 1)
        pairs = set()
        for k, (s, l) in enumerate(zip(rs.tolist(), rl.tolist())):
            rid[s:s + l] = k + pi * (u_pad + 1)
            t0, t1 = s // b, (s + l - 1) // b
            for i in range(t0, t1 + 1):
                for j in range(i, t1 + 1):
                    pairs.add((i, j))
            total_big += l * (l - 1) // 2
        datas.append(dperm)
        rids.append(rid.astype(np.int32))
        pl = np.array(sorted(pairs), np.int32).reshape(-1, 2)
        pair_lists.append(pl + np.int32(pi * t))
        orders.append(order)

    data_host = np.concatenate(datas, axis=0)
    rid_all = np.concatenate(rids)
    pairs_all = np.concatenate(pair_lists, axis=0)
    n_all = len(big_parts) * u_pad
    if cap_total is None:
        # Bounded start even when the candidate count is astronomical
        # (degenerate low-entropy data): the chunked launcher reports
        # per-chunk totals and the retry loop grows the cap as needed,
        # never past one chunk's <2^29 worst case.
        cap_total = min(1 << 26,
                        1 << max(20, (2 * total_big - 1).bit_length()))
    cap_row = min(cap_row, b)

    data = _device_rep(data_host, metric, word_length)
    run = _xla_chunked_run(data, pairs_all, n_all, max_dist, tile=b,
                           metric=metric, word_length=word_length,
                           ids=rid_all)

    pa, pb = _extract_with_retry(run, u, b, cap_row, cap_total)
    # Stacked permuted positions -> original unique-word indices,
    # indexing each partition's order array directly (no [P, U] stack).
    ga = np.empty(len(pa), np.int64)
    gb = np.empty(len(pb), np.int64)
    for pi, order in enumerate(orders):
        sel = (pa // u_pad) == pi
        ga[sel] = order[pa[sel] % u_pad]
        sel = (pb // u_pad) == pi
        gb[sel] = order[pb[sel] % u_pad]
    return np.minimum(ga, gb), np.maximum(ga, gb)


try:
    from .._hostops import edit_filter_pairs as _edit_filter_native
    from .._hostops import merge_join_pairs as _merge_join_native
except ImportError:  # pragma: no cover - extension not built
    _edit_filter_native = None
    _merge_join_native = None


def _segment_keys_at(packed: np.ndarray, word_length: int, lo: int,
                     hi: int, codes: np.ndarray | None = None
                     ) -> np.ndarray:
    """[U] uint64 keys of the bases at positions [lo, hi) of every word
    (same bit layout as _segment_run_ids).  ``codes`` (pre-unpacked
    [U, L]) avoids re-unpacking wide words on every (segment, shift)."""
    u, w = packed.shape
    width = 2 * (hi - lo)
    if w <= 2:
        word64 = packed[:, 0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            word64 |= packed[:, 1].astype(np.uint64)
        return ((word64 >> np.uint64(64 - 2 * hi))
                & np.uint64((1 << width) - 1))
    if codes is None:
        from .. import words as W

        codes = W.unpack_words(packed, word_length)
    k = np.zeros(u, np.uint64)
    for c in range(lo, hi):
        k = (k << np.uint64(2)) | codes[:, c].astype(np.uint64)
    return k


def _edit_verify_host(codes: np.ndarray, a: np.ndarray, b: np.ndarray,
                      max_dist: int):
    """Keep candidate pairs within banded Levenshtein ``max_dist``
    (native C banded DP; numpy-free fallback via the test oracle DP)."""
    if len(a) == 0:
        return a, b
    if _edit_filter_native is not None:
        oa = np.empty(len(a), np.int64)
        ob = np.empty(len(a), np.int64)
        n = _edit_filter_native(
            np.ascontiguousarray(codes), codes.shape[1],
            np.ascontiguousarray(a), np.ascontiguousarray(b),
            int(max_dist), oa, ob)
        return oa[:n].copy(), ob[:n].copy()
    keep = np.zeros(len(a), bool)
    for i in range(len(a)):  # pragma: no cover - fallback
        keep[i] = _lev_py(codes[a[i]], codes[b[i]]) <= max_dist
    return a[keep], b[keep]


def _lev_py(x, y):  # pragma: no cover - fallback only
    L = len(x)
    row = list(range(L + 1))
    for i in range(1, L + 1):
        nrow = [i]
        for j in range(1, L + 1):
            nrow.append(min(row[j - 1] + (x[i - 1] != y[j - 1]),
                            row[j] + 1, nrow[-1] + 1))
        row = nrow
    return row[L]


def _sorted_run_counts(sk: np.ndarray):
    """(values, counts) of a SORTED uint64 array (no re-sort)."""
    if not len(sk):
        return sk, np.zeros(0, np.int64)
    new = np.empty(len(sk), bool)
    new[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    cnt = np.diff(np.append(starts, len(sk)))
    return sk[starts], cnt


def _join_size(ka_sorted: np.ndarray, kb_sorted: np.ndarray,
               self_join: bool) -> int:
    """Equal-key join output size from the sorted key arrays alone —
    shard-independent, so every host makes the same JoinCapExceeded
    decision before any ownership filtering."""
    ua, ca = _sorted_run_counts(ka_sorted)
    if self_join:
        return int((ca * (ca - 1) // 2).sum())
    ub, cb = _sorted_run_counts(kb_sorted)
    pos = np.searchsorted(ua, ub)
    pos_c = np.minimum(pos, max(len(ua) - 1, 0))
    m = (pos < len(ua)) & (ua[pos_c] == ub) if len(ua) else \
        np.zeros(len(ub), bool)
    return int((ca[pos_c[m]] * cb[m]).sum())


def find_edit_pairs_shifted(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    join_cap: int | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic Levenshtein neighbour pairs via shifted segments.

    Partition lemma with indels: in an alignment with <= m edits over
    m+1 contiguous query segments, at least one segment is untouched, so
    it appears EXACTLY in the partner word at its own position offset by
    the indel balance d in [-m, m].  For every (segment, shift) the
    equal-key pairs of (segment value at canonical position) x (segment
    value at shifted position) are candidates, generated by a sorted
    merge join (csrc/hostops.cpp) and verified with a banded
    Levenshtein DP.  Candidates ~ real pairs + (m+1)(2m+1) *
    U^2/4^(L/(m+1)) random collisions — subquadratic for typical word
    lengths, replacing the dense O(U^2) edit tile scan
    (findEditNeighbours, humid.cc:140-158).

    ``join_cap`` bounds a single join's output (default: a quarter of
    available memory at 16 bytes/pair, floor 2^26); degenerate key
    spaces (e.g. all-identical segments) exceeding it raise ValueError —
    the auto strategy catches that and falls back to the dense scan.
    """
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if _merge_join_native is None:
        raise RuntimeError(
            "shifted-segment edit search needs the native extension; "
            "use strategy='dense'")
    if join_cap is None:
        from .._util import avail_bytes

        join_cap = max(1 << 26, avail_bytes() // 4 // 16)

    from .unique import _stable_argsort_u64
    from .. import words as W

    n_seg = max_dist + 1
    bounds = [word_length * s // n_seg for s in range(n_seg + 1)]
    codes = np.ascontiguousarray(
        W.unpack_words(packed, word_length).astype(np.uint8))

    # Canonical keys + sort orders, one per segment (reused across
    # shifts); shifted keys sorted per (segment, shift).
    parts_a, parts_b = [], []
    t_cand = 0
    for s in range(n_seg):
        lo, hi = bounds[s], bounds[s + 1]
        ka = _segment_keys_at(packed, word_length, lo, hi, codes)
        # Segment 0's canonical key is the word prefix: identity order
        # (verified — a permuted table would silently lose pairs).
        oa = (np.arange(u, dtype=np.int64)
              if s == 0 and np.all(ka[1:] >= ka[:-1])
              else _stable_argsort_u64(ka))
        for d in range(-max_dist, max_dist + 1):
            if lo + d < 0 or hi + d > word_length:
                continue
            if d == 0:
                kb, ob, self_join = ka, oa, 1
            else:
                kb = _segment_keys_at(packed, word_length, lo + d,
                                      hi + d, codes)
                ob = _stable_argsort_u64(kb)
                self_join = 0
            if shard is not None:
                # Cap check BEFORE ownership filtering (uniform across
                # parts), then keep only the keys this part owns: equal
                # keys land on one owner, so each candidate is produced
                # by exactly one part per (segment, shift).
                need = _join_size(ka[oa], kb[ob], bool(self_join))
                if need > join_cap:
                    raise JoinCapExceeded(
                        f"shifted-segment join for (segment {s}, shift "
                        f"{d}) needs {need} candidate pairs (> join_cap="
                        f"{join_cap}); the key space is degenerate — "
                        "use strategy='dense' (CLI: "
                        "HUMID_TPU_STRATEGY=dense)")
                salt = s * (2 * max_dist + 1) + (d + max_dist)
                oa_j = oa[_owned_mask(ka, shard, salt)[oa]]
                ob_j = (oa_j if d == 0
                        else ob[_owned_mask(kb, shard, salt)[ob]])
            else:
                oa_j, ob_j = oa, ob
            cap = min(1 << 20, 1 << max(int(join_cap) - 1, 0).bit_length())
            while True:
                outa = np.empty(cap, np.int64)
                outb = np.empty(cap, np.int64)
                n = _merge_join_native(
                    np.ascontiguousarray(ka), np.ascontiguousarray(oa_j),
                    np.ascontiguousarray(kb), np.ascontiguousarray(ob_j),
                    self_join, outa, outb)
                if n >= 0:
                    break
                if -n > join_cap:
                    raise JoinCapExceeded(
                        f"shifted-segment join for (segment {s}, shift "
                        f"{d}) needs {-n} candidate pairs (> join_cap="
                        f"{join_cap}); the key space is degenerate — "
                        "use strategy='dense' (CLI: "
                        "HUMID_TPU_STRATEGY=dense)")
                cap = 1 << int(-n - 1).bit_length()
            t_cand += int(n)
            parts_a.append(outa[:n].copy())
            parts_b.append(outb[:n].copy())

    _note_stat("candidates", t_cand)
    a = np.concatenate(parts_a)
    b = np.concatenate(parts_b)
    if not len(a):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    a, b = _dedupe_pairs(a, b)
    return _edit_verify(packed, codes, a, b, max_dist, word_length)


def _edit_verify(packed, codes, a, b, max_dist, word_length):
    """Banded-Levenshtein candidate verification: the parallel native
    filter by default, the device kernel when forced via
    ``HUMID_TPU_EDIT_VERIFY=device``.  The sole
    caller already requires the native extension, so no absent-extension
    fallback is needed here."""
    import os as _os

    if _os.environ.get("HUMID_TPU_EDIT_VERIFY", "auto") == "device":
        from .edit import edit_pairs_verify

        return edit_pairs_verify(packed, a, b, max_dist, word_length)
    return _edit_verify_host(codes, a, b, max_dist)


def find_neighbor_pairs_bucketed(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int,
    tile: int = 2048,
    cap_row: int = 16,
    cap_total: int | None = None,
    impl: str | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Subquadratic Hamming neighbour pairs via pigeonhole partitions.

    Split each word into ``max_dist + 1`` contiguous segments: a pair
    within distance m agrees exactly on at least one segment (pigeonhole),
    so it suffices to compare words sharing a segment value.  Per
    partition, words are sorted by segment key; equal-key runs become
    contiguous, and only the tile pairs that overlap a run are scanned,
    with an in-kernel run-id equality mask rejecting cross-bucket pairs.
    A pair agreeing on several segments is found once per such partition;
    duplicates are removed at the end.

    Complexity per partition ~ O(U/tile) diagonal tiles plus extra tiles
    for runs crossing tile boundaries — versus O((U/tile)^2) dense.
    """
    if word_length is None:
        raise ValueError("bucketed strategy requires word_length")
    u, w = packed.shape
    if u <= 1 or max_dist == 0:
        # Unique words are pairwise distinct: no pairs at distance 0.
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    metric, tile = _resolve_metric("hamming", impl, word_length, tile)
    n_seg = max_dist + 1
    b = min(tile, _round_up(u, 256))
    u_pad = _round_up(u, b)
    t = u_pad // b
    if cap_total is None:
        # Power of two: distinct dataset sizes reuse compiled programs.
        # Clamped to the chunked launchers' 2^30 int32-safe ceiling.
        cap_total = min(1 << 30, 1 << max(20, (4 * u - 1).bit_length()))
    cap_row = min(cap_row, b)

    from .unique import _stable_argsort_u64

    # All partitions ride ONE device program: permuted copies of the data
    # are stacked (partition p occupies rows [p*u_pad, (p+1)*u_pad)), tile
    # indices are offset by p*t, and per-partition bucket ids get disjoint
    # ranges.  Real-vs-padding matches are impossible: padding rows carry
    # distinct negative ids.  (Zero-packed padding rows decode to all-'A'
    # words — distance 0 to each other — so the id mask, not the
    # packing, is the safety invariant.)
    datas: list[np.ndarray] = [None] * n_seg
    rids: list[np.ndarray] = [None] * n_seg
    pair_lists: list[np.ndarray] = [None] * n_seg
    orders = np.empty((n_seg, u), np.int64)
    keys = _segment_run_ids(packed, word_length, n_seg)

    def _prep_partition(p):
        key = keys[p]
        if p == 0 and np.all(key[1:] >= key[:-1]):
            # Prefix key of the ascending unique table: identity order
            # (verified — a permuted table would silently lose pairs).
            order = np.arange(u, dtype=np.int64)
            kperm = key
            dperm = packed
        else:
            order = _stable_argsort_u64(key)
            kperm = key[order]
            dperm = packed[order]
        orders[p] = order
        # Dense int32 run ids (key equality == run-id equality), offset
        # into a per-partition id range.
        new_run = np.empty(u, bool)
        new_run[0] = True
        np.not_equal(kperm[1:], kperm[:-1], out=new_run[1:])
        rid = (np.cumsum(new_run) - 1).astype(np.int32) + p * (u_pad + 1)
        if u_pad > u:
            dperm = np.concatenate(
                [dperm, np.zeros((u_pad - u, w), dperm.dtype)]
            )
            rid = np.concatenate([
                rid,
                -np.arange(1, u_pad - u + 1, dtype=np.int32)
                - p * (u_pad + 1),
            ])
        # Tile pairs: diagonal always; run crossing tiles a..c adds the
        # tile pairs it spans (rare unless a bucket is huge).  If the
        # crossing spans approach the dense grid, fall back to it rather
        # than enumerating in Python.
        run_starts = np.flatnonzero(new_run)
        run_ends = np.append(run_starts[1:], u)
        t0 = run_starts // b
        t1 = (run_ends - 1) // b
        cross = t1 > t0
        spans = t1[cross] - t0[cross] + 1
        extra = int((spans * (spans + 1) // 2).sum())
        if extra >= t * (t + 1) // 4:
            ii, jj = np.triu_indices(t)
            pairs_raw = np.stack([ii, jj], axis=1).astype(np.int32)
        else:
            pairs = {(i, i) for i in range(t)}
            for a0, a1 in zip(t0[cross], t1[cross]):
                for i in range(int(a0), int(a1) + 1):
                    for j in range(i, int(a1) + 1):
                        pairs.add((i, j))
            pairs_raw = np.array(sorted(pairs), np.int32).reshape(-1, 2)
        datas[p] = dperm
        rids[p] = rid
        pair_lists[p] = pairs_raw + np.int32(p * t)

    # Partitions prep (sort + gather + run detection) is independent and
    # spends its time in GIL-releasing native/numpy calls.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_seg) as ex:
        list(ex.map(_prep_partition, range(n_seg)))

    data_host = np.concatenate(datas, axis=0)      # [n_seg*u_pad, W]
    rid_all = np.concatenate(rids)
    pairs_all = np.concatenate(pair_lists, axis=0)
    n_all = n_seg * u_pad
    if shard is not None:
        # Within a partition each unordered pair is emitted by exactly
        # one tile pair (the one its two permuted positions fall in), so
        # striping the stacked tile-pair list partitions each
        # partition's pair set exactly; cross-partition duplicates are
        # deduplicated by the caller after gathering all parts.
        pairs_all = pairs_all[shard[0]::shard[1]]
        _note_stat("candidates", len(pairs_all) * b * b)
        if not len(pairs_all):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)

    data = _device_rep(data_host, metric, word_length)
    run = _xla_chunked_run(data, pairs_all, n_all, max_dist, tile=b,
                           metric=metric, word_length=word_length,
                           ids=rid_all)

    pa, pb = _extract_with_retry(run, u, b, cap_row, cap_total)
    # Stacked permuted positions -> original unique-word indices.
    ga = orders[pa // u_pad, pa % u_pad]
    gb = orders[pb // u_pad, pb % u_pad]
    a = np.minimum(ga, gb)
    bb = np.maximum(ga, gb)
    # A pair agreeing on k>1 segments appears k times; dedupe + sort.
    return _dedupe_pairs(a, bb)


def pairs_to_csr(
    a: np.ndarray, b: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize pair list into CSR with ascending neighbour lists.

    Returns (indptr [U+1], indices [2E]) int64.
    """
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.lexsort((dst, src))
    src = src[order]
    dst = dst[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    if len(src):
        # bincount beats np.add.at's buffered fancy-index accumulate by
        # ~an order of magnitude on WGS-scale edge lists.
        indptr[1:] = np.bincount(src, minlength=num_nodes)
    np.cumsum(indptr, out=indptr)
    return indptr, dst
