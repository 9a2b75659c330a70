"""Exact-duplicate counting over packed word fingerprints.

Replaces the reference's trie insertion + leaf counts (humid.cc:92-99,
trie.add at humid.cc:95).  The trie's lexicographic ``walk()`` order
(humid.cc:117,178) is reproduced for free: unique fingerprints are returned
in ascending lane-lexicographic order, which equals lexicographic word
order because :func:`humid_tpu.words.pack_words` packs big-endian.
"""

from __future__ import annotations

import numpy as np

try:
    from .._hostops import argsort_u64 as _argsort_u64
    from .._hostops import unique_u64 as _unique_u64
    from .._hostops import unique_packed as _unique_packed
except ImportError:  # pragma: no cover - extension not built
    _argsort_u64 = None
    _unique_u64 = None
    _unique_packed = None


def _unique_packed_native(packed: np.ndarray, want_inverse: bool):
    """Fully fused native path: key build + stable radix sort + group
    structure all in C (csrc/hostops.cpp unique_packed).  Outputs are
    np.empty buffers sized n of which only k entries are faulted, so
    the visible cost is ~two parallel passes over the keys."""
    n, w = packed.shape
    packed = np.ascontiguousarray(packed)
    uniq = np.empty((n, w), np.uint32)
    counts = np.empty(n, np.int64)
    first_occ = np.empty(n, np.int64)
    inverse = np.empty(n if want_inverse else 1, np.int64)
    k = _unique_packed(packed, w, uniq, counts, first_occ, inverse,
                       int(want_inverse))
    return (uniq[:k].copy(), counts[:k].copy(), first_occ[:k].copy(),
            inverse if want_inverse else None)


def _unique_by_key_native(packed: np.ndarray, key: np.ndarray,
                          want_inverse: bool = True):
    """Fused native sort + group structure (csrc/hostops.cpp)."""
    n = len(key)
    order = np.empty(n, np.int64)
    group_start = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    first_occ = np.empty(n, np.int64)
    inverse = np.empty(n if want_inverse else 1, np.int64)
    k = _unique_u64(np.ascontiguousarray(key), order, group_start,
                    counts, first_occ, inverse, int(want_inverse))
    uniq = packed[order[group_start[:k]]]
    return (uniq, counts[:k].copy(), first_occ[:k].copy(),
            inverse if want_inverse else None)


def _stable_argsort_u64(key: np.ndarray) -> np.ndarray:
    if _argsort_u64 is not None:
        order = np.empty(len(key), np.int64)
        _argsort_u64(np.ascontiguousarray(key), order)
        return order
    return np.argsort(key, kind="stable")


def unique_words(packed: np.ndarray, want_inverse: bool = True,
                 _force_host: bool = False):
    """Group identical fingerprints.

    Args:
      packed: [N, W] uint32 fingerprint lanes (unfiltered words only).
      want_inverse: skip building the [N] row->unique map when the
        caller doesn't need per-read labels (dedup-only runs) — the
        random-scatter inverse write is a large share of unique time at
        WGS scale.
      _force_host: bypass the engine router (used by the router's own
        calibration probe, humid_tpu._backend._measure_engines).

    Returns:
      uniq:       [U, W] uint32, ascending lexicographic order.
      counts:     [U]   int64 exact-duplicate count per unique word
                  (== trie leaf ``count``).
      first_occ:  [U]   int64 index (into the N input rows) of the first
                  occurrence of each unique word in input order — the
                  representative the dedup writer emits (humid.cc:224-231).
      inverse:    [N]   int64 mapping row -> unique index (None when
                  ``want_inverse`` is False).
    """
    n, w = packed.shape
    if n == 0:
        return (
            np.zeros((0, w), np.uint32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64) if want_inverse else None,
        )
    import os as _os

    env = _os.environ.get("HUMID_TPU_UNIQUE")
    if env == "device" and not _force_host:
        return unique_words_device(packed, want_inverse)
    if env != "host" and not _force_host and n > (1 << 16):
        # Production engine choice: routed by MEASURED per-row cost of
        # both engines on this machine (calibrated once per device kind
        # + core count, humid_tpu._backend), gated on a local GPU.  On
        # the CPU backend the host path is the default.
        from .._backend import use_device_engine

        if use_device_engine("unique"):
            return unique_words_device(packed, want_inverse)
    # Stable sort in lane-lexicographic order.  For <= 2 lanes a single
    # uint64 key suffices, and the fused native path does sort + group
    # structure + inverse in one call.
    if w <= 2 and _unique_packed is not None and n <= np.iinfo(np.int32).max:
        return _unique_packed_native(packed, want_inverse)
    if w <= 2 and _unique_u64 is not None:
        if w == 1:
            key = packed[:, 0].astype(np.uint64)
        else:
            key = (packed[:, 0].astype(np.uint64) << np.uint64(32)) | \
                packed[:, 1].astype(np.uint64)
        return _unique_by_key_native(packed, key, want_inverse)
    if w == 1:
        order = _stable_argsort_u64(packed[:, 0].astype(np.uint64))
    elif w == 2:
        key = (packed[:, 0].astype(np.uint64) << np.uint64(32)) | \
            packed[:, 1].astype(np.uint64)
        order = _stable_argsort_u64(key)
    elif w <= 4 and _argsort_u64 is not None:
        # 3-4 lanes (word length 33-64): LSD two-pass over u64 halves
        # through the native radix sort — sort by the low half, then
        # stable-sort that order by the high half.
        def _half(lo_lane: int) -> np.ndarray:
            k = packed[:, lo_lane].astype(np.uint64) << np.uint64(32)
            if lo_lane + 1 < w:
                k |= packed[:, lo_lane + 1].astype(np.uint64)
            return k
        order = _stable_argsort_u64(_half(2))
        order = order[_stable_argsort_u64(_half(0)[order])]
    else:
        # Least-significant key last in np.lexsort's tuple.
        order = np.lexsort(tuple(packed[:, w - 1 - i] for i in range(w)))
    s = packed[order]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (s[1:] != s[:-1]).any(axis=1)
    group_start = np.flatnonzero(new_group)
    uniq = s[group_start]
    counts = np.diff(np.append(group_start, n)).astype(np.int64)
    # lexsort is stable -> within a group original indices ascend, so the
    # group's first sorted element is the first occurrence in input order.
    first_occ = order[group_start].astype(np.int64)
    if want_inverse:
        gid = np.cumsum(new_group) - 1
        inverse = np.empty(n, dtype=np.int64)
        inverse[order] = gid
    else:
        inverse = None
    return uniq, counts, first_occ, inverse


def unique_words_device(packed: np.ndarray, want_inverse: bool = True):
    """Device-side unique counting: ``jax.lax.sort`` over the uint32
    lanes + segment scatters, same contract as :func:`unique_words`.

    Routed here when calibration measures it faster than the host
    radix sort, or forced with ``HUMID_TPU_UNIQUE=device``.  Input is padded to the
    next power of two (few distinct compiled programs); padding rows
    carry all-1 lanes, sort last, and are fenced off by a forced group
    boundary at the true row count, so a real all-T word never merges
    with them.
    """
    n, w = packed.shape
    if n == 0:
        return (np.zeros((0, w), np.uint32), np.zeros(0, np.int64),
                np.zeros(0, np.int64),
                np.zeros(0, np.int64) if want_inverse else None)
    import jax.numpy as jnp

    n_pad = 1 << max(n - 1, 0).bit_length()
    data = np.full((n_pad, w), np.uint32(0xFFFFFFFF))
    data[:n] = packed
    uniq, counts, first, inv, k = _unique_device_jit(
        jnp.asarray(data), jnp.int32(n), w=w, want_inverse=want_inverse)
    k = int(k)
    return (
        np.asarray(uniq[:k]).astype(np.uint32, copy=False),
        np.asarray(counts[:k]).astype(np.int64),
        np.asarray(first[:k]).astype(np.int64),
        (np.asarray(inv[:n]).astype(np.int64) if want_inverse else None),
    )


try:
    import functools as _functools

    import jax as _jax
    import jax.numpy as _jnp

    @_functools.partial(_jax.jit, static_argnames=("w", "want_inverse"))
    def _unique_device_jit(data, n_true, *, w: int, want_inverse: bool):
        n_pad = data.shape[0]
        idx = _jnp.arange(n_pad, dtype=_jnp.int32)
        ops = [data[:, i] for i in range(w)] + [idx]
        *skeys, sidx = _jax.lax.sort(ops, num_keys=w, is_stable=True)
        sk = _jnp.stack(skeys, axis=1)                     # [n_pad, w]
        new = _jnp.ones(n_pad, bool)
        if n_pad > 1:
            new = new.at[1:].set(_jnp.any(sk[1:] != sk[:-1], axis=1))
        # Fence the padding off from a possible real all-1 word: padding
        # sorts last (max key, stable), so it occupies rows >= n_true.
        new = new | (idx == n_true)
        gid = _jnp.cumsum(new.astype(_jnp.int32)) - 1      # [n_pad]
        k = gid[_jnp.maximum(n_true - 1, 0)] + 1
        counts = _jnp.zeros(n_pad, _jnp.int32).at[gid].add(1)
        # Stable sort: each group's first sorted element has the
        # smallest original index == first occurrence in input order.
        first = _jnp.full(n_pad, n_pad, _jnp.int32).at[gid].min(sidx)
        uniq = _jnp.zeros((n_pad, w), data.dtype).at[gid].set(sk)
        inv = (_jnp.zeros(n_pad, _jnp.int32).at[sidx].set(gid)
               if want_inverse else _jnp.zeros((), _jnp.int32))
        return uniq, counts, first, inv, k
except ImportError:  # pragma: no cover - jax always present in practice
    _unique_device_jit = None
