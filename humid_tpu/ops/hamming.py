"""Device Hamming-distance blocks over 2-bit packed fingerprints.

Replaces the reference's per-word fuzzy trie traversal
(``trie.asymmetricHamming``, humid.cc:113-130) with dense all-pairs tiles:

  mismatches(a, b) = popcount(((a ^ b) | ((a ^ b) >> 1)) & 0x55555555)

summed over uint32 lanes — each 2-bit base group contributes 1 iff the
bases differ.  Two equivalent device paths are provided:

* ``hamming_block_xor`` — VPU bitops (XOR + population_count), pure jnp.
* ``hamming_block_mxu`` — one-hot bf16 matmul on the tensor cores: the
  number of MATCHING bases of a pair is <onehot(a), onehot(b)>, so
  dist = L - matches.

Both are exact integer computations.

Role: these standalone block kernels are the REFERENCE ORACLES for the
production paths (the fused tile scan in :mod:`.neighbors` and the
runs-strategy host filter are tested against them)
and the building blocks of ``__graft_entry__``'s compile check; the
pipeline itself drives :func:`humid_tpu.ops.find_neighbor_pairs`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MASK_LO = np.uint32(0x55555555)


def _mismatch_counts(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[R, W] x [C, W] uint32 -> [R, C] int32 per-base mismatch counts."""
    z = a[:, None, :] ^ b[None, :, :]
    m = (z | (z >> 1)) & MASK_LO
    return jax.lax.population_count(m).sum(axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def hamming_block_xor(rows, cols, row_off, col_off, max_dist, cap: int):
    """Upper-triangle neighbour pairs between a row block and a column block.

    Reference building block / test oracle: the production pipeline uses
    the fused tile scan in ops/neighbors.py; this standalone block API
    is kept as the simplest correct statement of the semantics the fused
    paths are tested against (and as the __graft_entry__ compile probe).

    Args:
      rows: [R, W] uint32 packed fingerprints (global rows row_off..row_off+R).
      cols: [C, W] uint32 packed fingerprints (global cols col_off..).
      row_off, col_off: global offsets (int32 scalars).
      max_dist: maximum Hamming distance (int32 scalar).
      cap: static capacity of the returned pair buffer.

    Returns:
      (r_idx, c_idx): [cap] int32 global indices, padded with -1.
      count: true number of matches (detects capacity overflow).

    Only pairs with global_col > global_row are emitted, mirroring the
    asymmetric trie search that yields each unordered pair once
    (humid.cc:118-124).
    """
    dist = _mismatch_counts(rows, cols)
    r = rows.shape[0]
    c = cols.shape[0]
    gr = row_off + jax.lax.broadcasted_iota(jnp.int32, (r, c), 0)
    gc = col_off + jax.lax.broadcasted_iota(jnp.int32, (r, c), 1)
    mask = (dist <= max_dist) & (gc > gr)
    count = mask.sum(dtype=jnp.int32)
    ri, ci = jnp.nonzero(mask, size=cap, fill_value=-1)
    r_idx = jnp.where(ri >= 0, ri + row_off, -1).astype(jnp.int32)
    c_idx = jnp.where(ci >= 0, ci + col_off, -1).astype(jnp.int32)
    return r_idx, c_idx, count


def _onehot_bases(packed: jnp.ndarray, word_length: int) -> jnp.ndarray:
    """[N, W] uint32 -> [N, 4*word_length] bf16 one-hot base encoding."""
    n, w = packed.shape
    shifts = (2 * (15 - jnp.arange(16, dtype=jnp.uint32)))[None, None, :]
    codes = (packed[:, :, None] >> shifts) & jnp.uint32(3)
    codes = codes.reshape(n, w * 16)[:, :word_length].astype(jnp.int32)
    onehot = jax.nn.one_hot(codes, 4, dtype=jnp.bfloat16)
    return onehot.reshape(n, word_length * 4)


@functools.partial(jax.jit, static_argnames=("cap", "word_length"))
def hamming_block_mxu(rows, cols, row_off, col_off, max_dist, cap: int,
                      word_length: int):
    """Matmul variant of :func:`hamming_block_xor`: match counts via a
    one-hot bf16 matmul with float32 accumulation (tensor cores on a
    GPU).  Exact, so the tolerance against the xor path is zero: every
    operand is 0 or 1 and each dot is a sum of at most 4*word_length
    ones, exactly representable for word_length <= 256; no operand is
    float32, so TF32 never applies."""
    a = _onehot_bases(rows, word_length)
    b = _onehot_bases(cols, word_length)
    matches = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    dist = (word_length - matches).astype(jnp.int32)
    r = rows.shape[0]
    c = cols.shape[0]
    gr = row_off + jax.lax.broadcasted_iota(jnp.int32, (r, c), 0)
    gc = col_off + jax.lax.broadcasted_iota(jnp.int32, (r, c), 1)
    mask = (dist <= max_dist) & (gc > gr)
    count = mask.sum(dtype=jnp.int32)
    ri, ci = jnp.nonzero(mask, size=cap, fill_value=-1)
    r_idx = jnp.where(ri >= 0, ri + row_off, -1).astype(jnp.int32)
    c_idx = jnp.where(ci >= 0, ci + col_off, -1).astype(jnp.int32)
    return r_idx, c_idx, count
