"""Hamming distance between 256-bit ORB descriptors as an int8 matmul.

Replaces ORBmatcher::DescriptorDistance (ORBmatcher.cc:1647-1665, the 32-byte
popcount) and every brute-force distance matrix in ORBmatcher / DBoW2.

Two forms:
- `hamming_matrix(pm1_a, pm1_b)`: descriptors as {-1,+1} int8 vectors; the
  distance matrix is one int8 matmul with int32 accumulation (exact):
  ham = (256 - a.b) / 2.
  This is the hot path (frame-to-map matching, BoW scoring).
- `hamming_packed(a, b)`: XOR + popcount on packed uint8, for small/irregular
  comparisons.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def popcount_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Per-byte popcount (SWAR), returns int32."""
    x = x.astype(jnp.int32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_packed(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Packed [..., 32] uint8 descriptors -> Hamming distance [...]."""
    return jnp.sum(popcount_u8(jnp.bitwise_xor(a, b)), axis=-1)


def hamming_matrix(pm1_a: jnp.ndarray, pm1_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances via one int8 matmul.

    pm1_*: [N, 256] int8 in {-1, 0, +1} (0 rows = invalid -> distance 128).
    Returns [Na, Nb] int32.
    """
    dot = jax.lax.dot_general(
        pm1_a, pm1_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (256 - dot) >> 1


def best_two(dists: jnp.ndarray, axis: int = -1):
    """Best and second-best distances + best index along an axis.

    Used for the ratio test (mfNNratio) in ORBmatcher::SearchByBoW etc.
    Sort-free: XLA lowers top_k to a per-row sort, while min +
    masked-second-min is three cheap passes.
    """
    d = dists.swapaxes(axis, -1)
    best = jnp.min(d, axis=-1)
    arg = jnp.argmin(d, axis=-1).astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    masked = jnp.where(cols == arg[..., None], jnp.asarray(jnp.inf, d.dtype)
                       if jnp.issubdtype(d.dtype, jnp.floating)
                       else jnp.iinfo(d.dtype).max, d)
    second = jnp.min(masked, axis=-1)
    return best, second, arg
