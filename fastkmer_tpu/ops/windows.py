"""Log-step sliding-window primitives (pure jnp, XLA-fusable).

The reference computes minimizers with a serial rolling window + O(k·m)
rescans on expiry (SparkBinKmerCounter.scala:98-139, package.scala:337-357).
On a vector device that control flow is poison; instead we compute, for *every*
position at once:

* ``rolling_pack``  — packed 2-bit windows via shift-or doubling,
* ``window_min``    — window minimum via two overlapping power-of-two mins
  (the classic sparse-table / "parallel sliding window" trick, cf. the
  sliding-window-sums paper in PAPERS.md),

both O(log w) full-width elementwise passes with static shapes.
"""

from __future__ import annotations

import jax.numpy as jnp


def rolling_pack(codes2: jnp.ndarray, length: int) -> jnp.ndarray:
    """codes2: [..., L] uint32 of 2-bit values. Returns [..., L-length+1]
    where out[..., i] = codes2[i] .. codes2[i+length-1] packed big-endian
    (first base most significant).  Requires length <= 16.
    """
    assert 1 <= length <= 16
    L = codes2.shape[-1]
    assert L >= length
    # power-of-two packed windows, built by doubling
    pows = {1: codes2.astype(jnp.uint32)}
    s = 1
    while s * 2 <= length:
        v = pows[s]
        n = v.shape[-1] - s
        pows[s * 2] = (v[..., :n] << jnp.uint32(2 * s)) | v[..., s : s + n]
        s *= 2
    # compose `length` from its binary decomposition, walking left to right
    out = None
    pos = 0
    for bit in reversed(range(5)):
        p = 1 << bit
        if length & p:
            piece = pows[p]
            take = L - length + 1
            sl = piece[..., pos : pos + take]
            out = sl if out is None else ((out << jnp.uint32(2 * p)) | sl)
            pos += p
    return out


def window_min(a: jnp.ndarray, w: int) -> jnp.ndarray:
    """out[..., i] = min(a[..., i:i+w]) for i in 0..L-w  (O(log w) passes)."""
    assert w >= 1
    L = a.shape[-1]
    assert L >= w
    if w == 1:
        return a
    # largest power of two <= w
    p = 1 << (w.bit_length() - 1)
    if p == w:
        p >>= 1  # still need two overlapping halves unless w == 1
    g = a
    s = 1
    while s < p:
        n = g.shape[-1] - s
        g = jnp.minimum(g[..., :n], g[..., s : s + n])
        s *= 2
    # g[i] = min over [i, i+p)
    take = L - w + 1
    return jnp.minimum(g[..., :take], g[..., w - p : w - p + take])


def window_any(mask: jnp.ndarray, w: int) -> jnp.ndarray:
    """out[..., i] = any(mask[..., i:i+w]) — via window_min on inverted mask."""
    inv = jnp.where(mask, jnp.uint32(0), jnp.uint32(1))
    return window_min(inv, w) == jnp.uint32(0)
