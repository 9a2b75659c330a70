"""Device connected components via iterative min-label propagation.

Data-parallel replacement for the reference's recursive flood fill
(``assignMaxCluster``, cluster.cc:72-80): component MEMBERSHIP is identical,
computed as a data-parallel fixed-point instead of a pointer chase, and it
cannot blow the stack (docs/troubleshooting.rst:6-18).

Each node starts labeled with its own index; every sweep scatter-mins each
edge endpoint with the other endpoint's label and then pointer-jumps
(label <- label[label]), halving path lengths, so convergence is
O(log diameter) sweeps.  All shapes static; runs under jit and inside
shard_map (the distributed path min-reduces labels across shards between
sweeps, see humid_tpu.parallel).

Cluster ids are renumbered 1..K by ascending component minimum — exactly
the reference's seed order (first unassigned leaf in lexicographic walk
order, humid.cc:177-180).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("num_nodes",))
def _labelprop(edges_a, edges_b, num_nodes: int):
    init = jnp.arange(num_nodes, dtype=jnp.int32)

    def sweep(labels):
        la = labels[edges_a]
        lb = labels[edges_b]
        m = jnp.minimum(la, lb)
        labels = labels.at[edges_a].min(m)
        labels = labels.at[edges_b].min(m)
        # Pointer jumping: label <- label[label] until idempotent this sweep.
        labels = labels[labels]
        labels = labels[labels]
        return labels

    def cond(state):
        labels, prev, _ = state
        return jnp.any(labels != prev)

    def body(state):
        labels, _, it = state
        return sweep(labels), labels, it + 1

    labels = sweep(init)
    labels, _, iters = jax.lax.while_loop(cond, body, (sweep(labels), labels, jnp.int32(1)))
    return labels, iters


def connected_components_device(
    a: np.ndarray, b: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Component labels (= min node index in component) for an undirected
    edge list.  Padding edges (i, i) are harmless; pass a/b as int32."""
    if num_nodes == 0:
        return np.zeros(0, np.int32)
    if len(a) == 0:
        return np.arange(num_nodes, dtype=np.int32)
    labels, _ = _labelprop(
        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), num_nodes
    )
    return np.asarray(labels)


def renumber_components(labels: np.ndarray) -> tuple[np.ndarray, int,
                                                     np.ndarray]:
    """Map component labels (min-index) to 1-based cluster ids in ascending
    label order == reference seed order.  Returns (ids [U], num_clusters,
    seeds [num_clusters]) — the seeds ARE the sorted unique label values
    (each component's minimum node index), so callers need no extra
    scatter pass to recover them."""
    uniq, inv = np.unique(labels, return_inverse=True)
    return (inv + 1).astype(np.int64), len(uniq), uniq.astype(np.int64)
