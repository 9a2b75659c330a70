"""Fused device-resident pipeline: unique -> neighbours -> labels on-chip.

The phase-wise device engines each pay their own transfers: the device
unique engine ships N packed reads up and the unique table down, the
runs_device engine ships the SAME table back up plus per-partition
sorted orders, and the -x components engine ships the pair list up
again.  The reference runs its whole pipeline as one function over one
in-memory structure (humid.cc:369-409); this module is the device
analogue:

  * packed read batches stream to the device DURING pass-1 framing
    (``DeviceFeeder`` — donated in-place updates of one resident HBM
    buffer, so the h2d rides the wire while the host parses FastQ),
  * one device program sorts + uniques the reads IN HBM (the unique
    table never touches the host on its way to the neighbour search),
  * a second program computes the pigeonhole partition orders + run
    structure on-device (replacing the host radix sorts AND the
    order-table upload of ops/runs_device.py),
  * a third runs the offset-shift in-run Hamming sweeps of
    ops/runs_device.py against the resident table,
  * for ``-x``, a fourth runs min-label propagation over the resident
    match masks (plus the host-enumerated mid/big-run edges, uploaded
    once) so component labels are computed where the edges live,
  * the host sees ONE bundled download per stage boundary: the unique
    table + counts + first-occurrence + partition orders + run bitmaps
    (needed for the host mid/big-run enumeration and everything
    downstream), then the packed match bitmaps (+ labels).

Candidate semantics are identical to the runs engines (pigeonhole
completeness, humid.cc:113-130): runs of length <= d_max+1 are fully
covered by the device sweeps, mid runs are enumerated by the shared host
ladder (ops/neighbors.enumerate_run_pairs), oversized runs take the
shared big-run device tile fallback, degenerate tables fall back to the
dense strategy — so the deduplicated union equals the host engine's pair
list exactly (asserted by tests/test_fused.py across fuzzed inputs).

Routing: ``humid_tpu._backend.use_fused_pipeline`` (measured constant
``pipeline_fused_ns`` vs the best phase-wise alternative), or
``HUMID_TPU_FUSED=1/0`` to force.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .._util import concat_aranges as _concat_aranges
from .hamming import MASK_LO
from .runs_device import _bitmap_positions, _quantize_n, segment_lane_masks


class FusedCapacityExceeded(RuntimeError):
    """The feeder's pre-run row estimate undershot and growing would
    exceed the device budget — the pipeline falls back to the host
    pass-1 path (re-reading the input) instead of OOMing mid-sort."""


class _quiet_donation(warnings.catch_warnings):
    """Scoped suppression of jax's donation warning around the feeder's
    buffer updates ONLY: backends without donation support (the CPU
    backend tests run on) warn and copy instead — functionally
    identical, so the warning is pure noise there — while genuine
    donation regressions elsewhere in the process keep warning.  (The
    feeder runs on the main thread; catch_warnings' global-state swap
    is safe there.)"""

    def __enter__(self):
        super().__enter__()
        warnings.filterwarnings(
            "ignore", message="Some donated buffers were not usable")
        return self


# ---------------------------------------------------------------------------
# Device feeder: stream packed batches into one resident HBM buffer
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap", "w"))
def _init_buf(*, cap: int, w: int):
    # All-ones rows sort LAST (after every real word, stably after a
    # real all-T word by original index), so unwritten tail rows never
    # interleave with usable reads.
    return jnp.full((cap, w), jnp.uint32(0xFFFFFFFF))


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_buf(buf, x, i):
    return jax.lax.dynamic_update_slice(buf, x, (i, jnp.int32(0)))


@functools.partial(jax.jit, static_argnames=("add", "w"), donate_argnums=(0,))
def _grow_buf(buf, *, add: int, w: int):
    tail = jnp.full((add, w), jnp.uint32(0xFFFFFFFF))
    return jnp.concatenate([buf, tail], axis=0)


class DeviceFeeder:
    """Accumulates USABLE packed word batches into a device-resident
    [cap, w] uint32 buffer, row position == usable-read index (the
    caller pushes filtered-compacted batches in stream order, so the
    upload is 4w bytes per usable read — no flag lane, no filtered
    rows).  ``push`` is called from the pass-1 drain loop; uploads are
    dispatched asynchronously in fixed-size chunks so the h2d overlaps
    framing/decompression on the reader threads.  The buffer grows by
    doubling if the initial estimate was short."""

    def __init__(self, w: int, n_est: int, chunk_rows: int = 1 << 22):
        self.w = int(w)
        self.chunk = max(int(chunk_rows), 256)
        # Final-flush quantum: bounds both the padding waste and the
        # number of distinct compiled update programs.
        self.fq = max(128, self.chunk // 8)
        self.cap = _quantize_n(max(int(n_est), self.chunk))
        self.buf = _init_buf(cap=self.cap, w=self.w)
        self.n = 0        # usable rows uploaded (== next row's index)
        self._stage: list[np.ndarray] = []
        self._staged = 0
        self._done = False

    def push(self, packed: np.ndarray) -> None:
        assert not self._done
        if len(packed):
            self._stage.append(packed)
            self._staged += len(packed)
        while self._staged >= self.chunk:
            self._flush(self.chunk)

    def _take(self, rows: int) -> np.ndarray:
        """Pop exactly ``rows`` staged rows into a [rows, w] chunk."""
        out = np.empty((rows, self.w), np.uint32)
        got = 0
        while got < rows:
            packed = self._stage[0]
            take = min(rows - got, len(packed))
            out[got:got + take] = packed[:take]
            if take == len(packed):
                self._stage.pop(0)
            else:
                self._stage[0] = packed[take:]
            got += take
        self._staged -= rows
        return out

    def _ensure_cap(self, need_rows: int) -> None:
        while self.n + need_rows > self.cap:
            add = self.cap  # double; quantized values stay quantized
            if not fused_fits(self.cap + add, self.w):
                # The pre-run row estimate undershot (e.g. an extreme
                # compression ratio): growing past the HBM budget would
                # OOM mid-sort.  Raise the typed signal so the caller
                # can fall back to the host pass-1 path.
                raise FusedCapacityExceeded(
                    f"feeder would grow to {self.cap + add} rows, past "
                    f"the device budget (estimate undershot)")
            with _quiet_donation():
                self.buf = _grow_buf(self.buf, add=add, w=self.w)
            self.cap += add

    def _flush(self, rows: int) -> None:
        chunk = self._take(rows)
        self._ensure_cap(rows)
        with _quiet_donation():
            self.buf = _update_buf(self.buf, chunk, jnp.int32(self.n))
        self.n += rows

    def finish(self):
        """Flush the remainder (padded with all-ones rows to the final
        quantum) and return the device buffer."""
        if not self._done:
            if self._staged:
                rows = self._staged
                pad = -rows % self.fq
                if pad:
                    self._stage.append(np.full(
                        (pad, self.w), np.uint32(0xFFFFFFFF)))
                    self._staged += pad
                self._flush(rows + pad)
                self.n -= pad  # padding rows are not reads
            self._done = True
        return self.buf


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("w", "want_inverse"))
def _fused_unique_jit(buf, n_usable, *, w: int, want_inverse: bool):
    """Program A: sort the usable reads by their word lanes, group, and
    leave the unique table resident.  Buffer tail rows (all-ones) sort
    strictly after the usable rows (stable sort breaks the tie with a
    real all-T word by original index, and usable rows occupy indices
    < n_usable), so the valid unique groups are exactly gids 0..k-1
    with k = gid[n_usable-1]+1; the fence at sorted position n_usable
    keeps a real all-T group from merging with the padding."""
    cap = buf.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    ops = [buf[:, j] for j in range(w)] + [idx]
    *sk, sidx = jax.lax.sort(ops, num_keys=w, is_stable=True)
    skf = jnp.stack(sk, axis=1)                       # [cap, w]
    new = jnp.ones(cap, bool)
    if cap > 1:
        new = new.at[1:].set(jnp.any(skf[1:] != skf[:-1], axis=1))
    new = new | (idx == n_usable)  # fence real all-T off the padding
    gid = jnp.cumsum(new.astype(jnp.int32)) - 1
    k = jnp.where(n_usable > 0,
                  gid[jnp.maximum(n_usable - 1, 0)] + 1, 0)
    counts = jnp.zeros(cap, jnp.int32).at[gid].add(1)
    # Stable sort: each group's smallest original index == first
    # occurrence in usable-read order (the dedup representative).
    first = jnp.full(cap, cap, jnp.int32).at[gid].min(sidx)
    uniq = jnp.zeros((cap, w), jnp.uint32).at[gid].set(skf)
    uniq = jnp.where((idx < k)[:, None], uniq, jnp.uint32(0xFFFFFFFF))
    inv = (jnp.zeros(cap, jnp.int32).at[sidx].set(gid)
           if want_inverse else jnp.zeros((), jnp.int32))
    return uniq, counts, first, inv, k


@functools.partial(jax.jit, static_argnames=(
    "u_pad", "w", "n_seg", "d_cap", "run_cap"))
def _fused_partitions_jit(uniq_cap, k, seg_masks, *, u_pad: int, w: int,
                          n_seg: int, d_cap: int, run_cap: int):
    """Program B: per-pigeonhole-partition sorted orders + run structure
    over the RESIDENT table (replaces the host radix sorts and the order
    upload of ops/runs_device.py).  Returns
      orders  [n_seg-1, u_pad] int32  (partition 0 is the identity),
      runbits [n_seg, u_pad/32] uint32 packed run-start flags,
      hist    [d_cap+2] int32  rows of small runs by min(len-1, d_cap+1),
      big     [n_seg] int32    rows inside runs longer than run_cap.
    Run lengths count only valid rows (original index < k), so padding
    and filtered-word rows (all-ones, sorted last) never contribute."""
    t = uniq_cap[:u_pad]
    iota = jnp.arange(u_pad, dtype=jnp.int32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    orders, runbits, bigs = [], [], []
    hist = jnp.zeros(d_cap + 2, jnp.int32)
    for p in range(n_seg):
        mk = [t[:, j] & seg_masks[p, j] for j in range(w)]
        if p == 0:
            order = iota
            smk = mk
        else:
            *smk, order = jax.lax.sort(mk + [iota], num_keys=w,
                                       is_stable=True)
            orders.append(order)
        mkst = jnp.stack(smk, axis=1)
        new = jnp.ones(u_pad, bool)
        if u_pad > 1:
            new = new.at[1:].set(jnp.any(mkst[1:] != mkst[:-1], axis=1))
        rid = jnp.cumsum(new.astype(jnp.int32)) - 1
        valid = order < k
        rlen = jnp.zeros(u_pad, jnp.int32).at[rid].add(
            valid.astype(jnp.int32))
        l = rlen[rid]
        small_start = new & (l >= 2) & (l <= run_cap)
        wgt = jnp.where(small_start, l, 0)
        bin_ = jnp.clip(jnp.minimum(l - 1, d_cap + 1), 0, d_cap + 1)
        hist = hist.at[bin_].add(wgt)
        bigs.append(jnp.sum(jnp.where(new & (l > run_cap), l, 0)))
        runbits.append((new.reshape(-1, 32).astype(jnp.uint32)
                        * weights).sum(axis=1, dtype=jnp.uint32))
    orders_arr = (jnp.stack(orders) if orders
                  else jnp.zeros((1, u_pad), jnp.int32))
    return orders_arr, jnp.stack(runbits), hist, jnp.stack(bigs)


@functools.partial(jax.jit, static_argnames=(
    "d_lo", "d_hi", "n_seg", "w", "u_pad", "with_matches"))
def _fused_sweep_jit(uniq_cap, orders, seg_masks, k, max_dist, *,
                     d_lo: int, d_hi: int, n_seg: int, w: int,
                     u_pad: int, with_matches: bool):
    """Program C: the offset-shift in-run Hamming sweeps of
    ops/runs_device._runs_eval, against the resident table (no table or
    order upload), for offsets d_lo..d_hi.  The offset range is split so
    the base sweeps (d <= 2) launch WITHOUT waiting for the run-length
    histogram — the d_max decision round trip rides behind them, and a
    second program covers d > 2 only when the histogram asks for it.
    Returns packed bitmaps [n_seg, d_hi-d_lo+1, u_pad/32] and, when
    ``with_matches``, the raw bool masks kept resident for the
    label-propagation program."""
    t = uniq_cap[:u_pad]
    iota = jnp.arange(u_pad, dtype=jnp.int32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    outs, mats = [], []
    for p in range(n_seg):
        r = t if p == 0 else t[orders[p - 1]]
        mask_p = seg_masks[p][None, :]
        per_d, md = [], []
        for d in range(d_lo, d_hi + 1):
            shifted = jnp.concatenate(
                [r[d:], jnp.zeros((d, w), r.dtype)], axis=0)
            z = r ^ shifted
            in_run = ((z & mask_p) == 0).all(axis=1)
            m = (z | (z >> jnp.uint32(1))) & MASK_LO
            dist = jax.lax.population_count(m).sum(
                axis=-1).astype(jnp.int32)
            match = in_run & (dist <= max_dist) & (iota < k - d)
            per_d.append((match.reshape(-1, 32).astype(jnp.uint32)
                          * weights).sum(axis=1, dtype=jnp.uint32))
            if with_matches:
                md.append(match)
        outs.append(jnp.stack(per_d))
        if with_matches:
            mats.append(jnp.stack(md))
    bitmaps = jnp.stack(outs)
    matches = jnp.stack(mats) if with_matches else jnp.zeros((), bool)
    return bitmaps, matches


@jax.jit
def _gather_idx_jit(orders, part, pos):
    """Sparse order lookup: unique index of sorted position ``pos`` of
    partition ``part`` (>= 1; partition 0 is the identity and never
    queries).  Lets the host decode match bitmaps into unique-index
    pairs WITHOUT downloading the full [n_seg-1, U_pad] order tables."""
    return orders[part - 1, pos]


@jax.jit
def _gather_rows_jit(uniq_cap, orders, part, pos):
    """Sparse row gather: (unique index, word lanes) of sorted position
    ``pos`` of partition ``part`` — the mid-run members' words for the
    host enumeration ladder, fetched without downloading the table."""
    idx = jnp.where(part == 0, pos,
                    orders[jnp.maximum(part - 1, 0), pos])
    return idx, uniq_cap[idx]


@functools.partial(jax.jit, static_argnames=("d_max", "n_seg", "u_pad"))
def _fused_labels_jit(matches, orders, extra_a, extra_b, *, d_max: int,
                      n_seg: int, u_pad: int):
    """Program D (-x): min-label propagation directly over the resident
    match masks + the host-enumerated mid/big-run edges (uploaded once,
    padded with (0, 0) self-loops).  Component membership equals
    cluster/labelprop.connected_components_device over the full pair
    list; ids are finalized bit-exactly on host afterwards
    (cluster.exact.cluster_max_from_components)."""
    BIG = jnp.int32(np.iinfo(np.int32).max)

    def sweep(labels):
        for p in range(n_seg):
            order = None if p == 0 else orders[p - 1]
            for d in range(1, d_max + 1):
                lp = labels if order is None else labels[order]
                lpd = jnp.concatenate(
                    [lp[d:], jnp.full(d, BIG, jnp.int32)])
                m = jnp.where(matches[p, d - 1],
                              jnp.minimum(lp, lpd), BIG)
                mshift = jnp.concatenate(
                    [jnp.full(d, BIG, jnp.int32), m[:-d]])
                mm = jnp.minimum(m, mshift)
                labels = (jnp.minimum(labels, mm) if order is None
                          else labels.at[order].min(mm))
        la = labels[extra_a]
        lb = labels[extra_b]
        mm = jnp.minimum(la, lb)
        labels = labels.at[extra_a].min(mm).at[extra_b].min(mm)
        labels = labels[labels]
        labels = labels[labels]
        return labels

    init = jnp.arange(u_pad, dtype=jnp.int32)

    def cond(s):
        labels, prev = s
        return jnp.any(labels != prev)

    def body(s):
        labels, _ = s
        return sweep(labels), labels

    l0 = sweep(init)
    labels, _ = jax.lax.while_loop(cond, body, (sweep(l0), l0))
    return labels


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

def device_bytes_limit() -> int | None:
    """Bytes the first local device's allocator may hand out
    (``memory_stats()["bytes_limit"]``), or None where the backend
    reports no limit (the CPU backend).  On a GPU this is the pool XLA
    preallocates — by default 75% of the card's memory, so the limit
    already excludes the reserve XLA leaves for itself."""
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
    except Exception:  # pragma: no cover - backend without memory_stats
        return None
    limit = stats.get("bytes_limit")
    return int(limit) if limit else None


def fused_fits(n_rows: int, w: int) -> bool:
    """Device-memory budget check for the fused route: the read sort
    (program A) is the high-water mark, ~6x the buffer bytes in
    transient operands.  Without a reported ``bytes_limit`` the route is
    not eligible: an unknown budget is not assumed."""
    limit = device_bytes_limit()
    if limit is None:
        return False
    need = _quantize_n(max(int(n_rows), 1)) * (w + 2) * 4 * 6
    return need < limit


class FusedPipeline:
    """Drives the fused device-resident programs and assembles the host
    views the rest of the pipeline needs.  Stage methods map to pipeline
    phases: ``unique()`` (pass-1 tail), ``tables()``, ``neighbors()``,
    ``device_labels()`` (-x cluster phase)."""

    def __init__(self, feeder: DeviceFeeder, n_total: int,
                 filtered: np.ndarray, *, word_length: int, max_dist: int,
                 want_inverse: bool, want_labels: bool = False,
                 d_cap: int = 8, run_cap: int = 2048, tile: int = 2048,
                 cap_row: int = 16, cap_total: int | None = None,
                 impl: str | None = None):
        self.feeder = feeder
        self.n_total = int(n_total)
        self.filtered = filtered
        self.word_length = int(word_length)
        self.max_dist = int(max_dist)
        self.want_inverse = want_inverse
        self.want_labels = want_labels
        self.d_cap = d_cap
        self.run_cap = run_cap
        self.tile = tile
        self.cap_row = cap_row
        self.cap_total = cap_total
        self.impl = impl
        self.w = feeder.w
        self.k = 0
        self.uniq: np.ndarray | None = None
        self._matches = None
        self._extra: tuple[np.ndarray, np.ndarray] | None = None
        self._d_max = 0
        self._any_filtered = bool(np.count_nonzero(filtered))
        self.n_usable = self.n_total - int(np.count_nonzero(filtered))
        # usable-row index -> global read index (identity when nothing
        # was filtered; the feeder holds only usable rows).
        self._usable_to_read = (np.flatnonzero(~filtered)
                                if self._any_filtered else None)

    # -- stage 1: unique counting ------------------------------------
    def unique(self) -> int:
        buf = self.feeder.finish()
        assert self.feeder.n == self.n_usable, \
            f"feeder rows {self.feeder.n} != usable {self.n_usable}"
        uniq_cap, counts, first, inv, k = _fused_unique_jit(
            buf, jnp.int32(self.n_usable), w=self.w,
            want_inverse=self.want_inverse)
        self.k = int(k)  # the one tiny sync of this stage
        self._uniq_cap = uniq_cap
        qk = _quantize_n(max(self.k, 1))
        self._counts_d = counts[:qk]
        self._first_d = first[:qk]
        self._inv_d = (inv[:max(self.n_usable, 1)]
                       if self.want_inverse else None)
        return self.k

    # -- table download (bundled) ------------------------------------
    def tables(self):
        """counts [k] int64, first_occ [k] int64 (GLOBAL read indices),
        inv_by_read [n_total] int64 with -1 for filtered reads (or None)
        — one bundled device_get."""
        arrs = [self._counts_d, self._first_d]
        if self._inv_d is not None:
            arrs.append(self._inv_d)
        got = jax.device_get(arrs)
        counts = np.asarray(got[0])[:self.k].astype(np.int64)
        first_u = np.asarray(got[1])[:self.k].astype(np.int64)
        # Device indices are usable-row indices; convert to global.
        if self._any_filtered and len(first_u):
            first = self._usable_to_read[first_u]
        else:
            first = first_u
        inv = None
        if self._inv_d is not None:
            inv_u = np.asarray(got[2])[:self.n_usable].astype(np.int64)
            inv = np.full(self.n_total, -1, np.int64)
            if self.n_usable:
                if self._any_filtered:
                    inv[self._usable_to_read] = inv_u
                else:
                    inv[:] = inv_u
        return counts, first, inv

    # -- lazy host copy of the table ---------------------------------
    def table(self) -> np.ndarray:
        """Host copy of the unique table — lazy: the sparse decode path
        never downloads it (only fallbacks and callers that genuinely
        need the rows do)."""
        if self.uniq is None:
            if self.k:
                u_pad = _quantize_n(self.k)
                self.uniq = np.ascontiguousarray(
                    np.asarray(self._uniq_cap[:u_pad])[:self.k])
            else:
                self.uniq = np.zeros((0, self.w), np.uint32)
        return self.uniq

    # -- stage 2: neighbour pairs ------------------------------------
    def neighbors(self) -> tuple[np.ndarray, np.ndarray]:
        from .neighbors import (
            LAST_DECISION, _big_run_pairs, _combined_u64, _dedupe_pairs,
            _note_strategy, enumerate_run_pairs, find_neighbor_pairs)

        k = self.k
        _note_strategy("fused")
        if k <= 1 or self.max_dist == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)

        n_seg = self.max_dist + 1
        u_pad = _quantize_n(k)
        self._u_pad = u_pad
        seg_masks = segment_lane_masks(self.word_length, n_seg, self.w)
        seg_masks_d = jnp.asarray(seg_masks)
        orders_d, runbits_d, hist_d, big_d = _fused_partitions_jit(
            self._uniq_cap, jnp.int32(k), seg_masks_d, u_pad=u_pad,
            w=self.w, n_seg=n_seg, d_cap=self.d_cap,
            run_cap=self.run_cap)
        self._orders_d = orders_d
        # Launch the base sweeps (d <= 2) IMMEDIATELY — they are wanted
        # at every d_max, so the histogram round trip below rides
        # behind them instead of gating the whole sweep.
        d_base = min(2, self.d_cap)
        base_fut = _fused_sweep_jit(
            self._uniq_cap, orders_d, seg_masks_d, jnp.int32(k),
            jnp.int32(self.max_dist), d_lo=1, d_hi=d_base, n_seg=n_seg,
            w=self.w, u_pad=u_pad, with_matches=self.want_labels)
        # Small d2h only: run-start bitmaps + routing scalars.  The
        # table and the order permutations STAY on the device; the
        # decode below fetches just the sparse rows it touches.
        runbits_np, hist, big_rows = jax.device_get(
            [runbits_d, hist_d, big_d])

        if int(big_rows.sum()) > k:
            # Degenerate data (giant runs): same uniform dense fallback
            # as the runs engines, from a host copy of the table.
            return find_neighbor_pairs(
                self.table(), self.max_dist, metric="hamming",
                word_length=self.word_length, strategy="dense",
                impl=self.impl, tile=self.tile, cap_row=self.cap_row,
                cap_total=self.cap_total)

        # Adaptive sweep depth — same ladder as runs_device_pairs, but
        # never below the base sweeps already in flight (their extra
        # offsets only shrink the mid-run set).
        d_max = 1
        while (d_max < self.d_cap
               and int(hist[d_max + 1:].sum()) > max(k // 50, 64)):
            d_max *= 2
        d_max = min(max(d_max, d_base), self.d_cap)
        self._d_max = d_max

        ext_fut = None
        if d_max > d_base:
            ext_fut = _fused_sweep_jit(
                self._uniq_cap, orders_d, seg_masks_d, jnp.int32(k),
                jnp.int32(self.max_dist), d_lo=d_base + 1, d_hi=d_max,
                n_seg=n_seg, w=self.w, u_pad=u_pad,
                with_matches=self.want_labels)

        # Host run structure from the bitmaps while the sweep flies.
        structs = []      # (run_start, run_len) per partition (valid rows)
        big_parts_pos = []  # (p, big run starts, lens) in sorted space
        mid_total = 0
        cand_stat = 0
        for p in range(n_seg):
            new = np.unpackbits(
                np.ascontiguousarray(runbits_np[p]).view(np.uint8),
                bitorder="little")[:k].astype(bool)
            run_start = np.flatnonzero(new).astype(np.int64)
            run_len = np.diff(np.append(run_start, k))
            structs.append((run_start, run_len))
            small = (run_len >= 2) & (run_len <= self.run_cap)
            sl = run_len[small]
            if len(sl):
                cand_stat += int((sl * (sl - 1) // 2).sum())
            mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
            mid_total += int(run_len[mid].sum())
            big = run_len > self.run_cap
            if big.any():
                big_parts_pos.append((p, run_start[big].copy(),
                                      run_len[big].copy()))
        LAST_DECISION["candidates"] = cand_stat
        LAST_DECISION["d_max"] = d_max

        base_bm, base_mt = base_fut
        if ext_fut is not None:
            ext_bm, ext_mt = ext_fut
            bitmaps = np.concatenate(
                [np.asarray(base_bm), np.asarray(ext_bm)], axis=1)
            if self.want_labels:
                self._matches = jnp.concatenate([base_mt, ext_mt],
                                                axis=1)
        else:
            bitmaps = np.asarray(base_bm)
            if self.want_labels:
                self._matches = base_mt

        # Decode match positions per (partition, offset).
        pos_pd = {}
        n_q_pairs = 0
        for p in range(n_seg):
            for d in range(1, d_max + 1):
                pos = _bitmap_positions(bitmaps[p, d - 1], k)
                if len(pos):
                    pos_pd[(p, d)] = pos
                    if p > 0:
                        n_q_pairs += 2 * len(pos)

        # Sparse-vs-full decision: fetch only the touched rows when that
        # traffic undercuts downloading the full order tables + table
        # (big runs keep the full path — the tile fallback needs whole
        # permutations).
        sparse_bytes = (n_q_pairs * 8
                        + mid_total * (8 + 4 * self.w))
        full_bytes = 4 * u_pad * (n_seg - 1) + 4 * self.w * u_pad
        use_sparse = not big_parts_pos and sparse_bytes < full_bytes
        LAST_DECISION["decode"] = "sparse" if use_sparse else "full"

        parts_a: list[np.ndarray] = []
        parts_b: list[np.ndarray] = []
        extra_a: list[np.ndarray] = []
        extra_b: list[np.ndarray] = []

        if use_sparse:
            # Mid runs: gather (unique idx, word lanes) of members only.
            if mid_total:
                q_part, q_pos, runs_rel = [], [], []
                for p in range(n_seg):
                    run_start, run_len = structs[p]
                    mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
                    if not mid.any():
                        continue
                    ms, ml = run_start[mid], run_len[mid]
                    pos = np.repeat(ms, ml) + _concat_aranges(ml)
                    q_part.append(np.full(len(pos), p, np.int32))
                    q_pos.append(pos.astype(np.int32))
                    runs_rel.append(ml)
                q_part = np.concatenate(q_part)
                q_pos = np.concatenate(q_pos)
                q_pad = max(128, _quantize_n(len(q_pos)))
                part_p = np.zeros(q_pad, np.int32)
                pos_p = np.zeros(q_pad, np.int32)
                part_p[:len(q_part)] = q_part
                pos_p[:len(q_pos)] = q_pos
                idx_d, words_d = _gather_rows_jit(
                    self._uniq_cap, orders_d, jnp.asarray(part_p),
                    jnp.asarray(pos_p))
                idx_np, words_np = jax.device_get([idx_d, words_d])
                gidx = idx_np[:len(q_pos)].astype(np.int64)
                words = words_np[:len(q_pos)]
                lens = np.concatenate(runs_rel)
                starts_rel = np.concatenate(
                    [[0], np.cumsum(lens)[:-1]]).astype(np.int64)
                w64 = _combined_u64(words) if self.w <= 2 else None
                ma, mb, _ = enumerate_run_pairs(
                    words, w64, np.arange(len(words), dtype=np.int64),
                    starts_rel, lens, self.max_dist)
                ma = gidx[ma]
                mb = gidx[mb]
                ma, mb = np.minimum(ma, mb), np.maximum(ma, mb)
                parts_a.append(ma)
                parts_b.append(mb)
                extra_a.append(ma)
                extra_b.append(mb)
            # Pair decode: partition 0's order is the identity; the
            # other partitions' endpoints come from one sparse gather.
            q_part, q_pos, segs = [], [], []
            for (p, d), pos in pos_pd.items():
                if p == 0:
                    parts_a.append(pos)
                    parts_b.append(pos + d)
                else:
                    q_part.append(np.full(2 * len(pos), p, np.int32))
                    q_pos.append(np.concatenate(
                        [pos, pos + d]).astype(np.int32))
                    segs.append(len(pos))
            if q_pos:
                q_part = np.concatenate(q_part)
                q_pos = np.concatenate(q_pos)
                q_pad = max(128, _quantize_n(len(q_pos)))
                part_p = np.ones(q_pad, np.int32)
                pos_p = np.zeros(q_pad, np.int32)
                part_p[:len(q_part)] = q_part
                pos_p[:len(q_pos)] = q_pos
                idx_np = np.asarray(_gather_idx_jit(
                    orders_d, jnp.asarray(part_p), jnp.asarray(pos_p)))
                off = 0
                for m in segs:
                    ga = idx_np[off:off + m].astype(np.int64)
                    gb = idx_np[off + m:off + 2 * m].astype(np.int64)
                    off += 2 * m
                    parts_a.append(np.minimum(ga, gb))
                    parts_b.append(np.maximum(ga, gb))
        else:
            # Full path: download the table + order permutations once.
            uniq = self.table()
            orders_np = np.asarray(orders_d)
            word64 = _combined_u64(uniq) if self.w <= 2 else None
            big_parts = []
            for p in range(n_seg):
                run_start, run_len = structs[p]
                order = (np.arange(k, dtype=np.int64) if p == 0
                         else orders_np[p - 1][:k].astype(np.int64))
                mid = (run_len > d_max + 1) & (run_len <= self.run_cap)
                if mid.any():
                    ma, mb, _ = enumerate_run_pairs(
                        uniq, word64, order, run_start[mid],
                        run_len[mid], self.max_dist)
                    parts_a.append(ma)
                    parts_b.append(mb)
                    extra_a.append(ma)
                    extra_b.append(mb)
                big = run_len > self.run_cap
                if big.any():
                    big_parts.append((p, order, run_start[big].copy(),
                                      run_len[big].copy()))
                for d in range(1, d_max + 1):
                    pos = pos_pd.get((p, d))
                    if pos is None:
                        continue
                    ga = order[pos]
                    gb = order[pos + d]
                    parts_a.append(np.minimum(ga, gb))
                    parts_b.append(np.maximum(ga, gb))
            if big_parts:
                ba, bb = _big_run_pairs(
                    uniq, big_parts, self.max_dist,
                    word_length=self.word_length, tile=self.tile,
                    cap_row=self.cap_row, cap_total=self.cap_total,
                    impl=self.impl)
                parts_a.append(ba)
                parts_b.append(bb)
                extra_a.append(ba)
                extra_b.append(bb)

        if self.want_labels:
            self._extra = (
                np.concatenate(extra_a) if extra_a
                else np.zeros(0, np.int64),
                np.concatenate(extra_b) if extra_b
                else np.zeros(0, np.int64))
        if not parts_a:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return _dedupe_pairs(np.concatenate(parts_a),
                             np.concatenate(parts_b))

    # -- stage 3 (-x): device component labels -----------------------
    @property
    def has_matches(self) -> bool:
        return self._matches is not None

    def device_labels(self) -> np.ndarray:
        """Component labels (min unique index per component) for the
        valid rows, from on-device label propagation over the resident
        match masks + the uploaded mid/big edges."""
        assert self._matches is not None
        ea, eb = self._extra
        e_pad = max(128, _quantize_n(max(len(ea), 1)))
        ea_p = np.zeros(e_pad, np.int32)
        eb_p = np.zeros(e_pad, np.int32)
        ea_p[:len(ea)] = ea
        eb_p[:len(eb)] = eb
        labels = _fused_labels_jit(
            self._matches, self._orders_d, jnp.asarray(ea_p),
            jnp.asarray(eb_p), d_max=self._d_max,
            n_seg=self.max_dist + 1, u_pad=self._u_pad)
        return np.asarray(labels)[:self.k]


def fused_probe(packed_reads: np.ndarray, word_length: int,
                max_dist: int = 1):
    """One end-to-end fused run over an in-memory packed read array (no
    filtering): the measured unit for calibration
    (humid_tpu._backend) and scripts/engine_xover.py.  Returns
    (k, counts, first_occ, (pa, pb)) — the table itself stays on the
    device (sparse decode) unless a fallback needed it."""
    n, w = packed_reads.shape
    feeder = DeviceFeeder(w, n)
    filtered = np.zeros(n, bool)
    feeder.push(packed_reads)
    fp = FusedPipeline(feeder, n, filtered, word_length=word_length,
                       max_dist=max_dist, want_inverse=False)
    fp.unique()
    pa, pb = fp.neighbors()
    counts, first, _ = fp.tables()
    return fp.k, counts, first, (pa, pb)
