"""Recompute a k-mer's bin from its packed canonical words.

The signature (minimizer) is a pure function of the k-mer string (SURVEY.md
§0), so the bin never needs to ride through sorts or collectives as a
carried column — recomputing it with ~k·log(k) elementwise ops over the
final rows is far cheaper than permuting a 4-byte lane through every pass
of a sort or shipping it across the interconnect.  This is a deliberate
inversion of the reference design, where the bin key IS the shuffle route
and must travel with the payload.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import jbits
from ..core.bits import BASES_PER_WORD, num_words


def unpack_words(words: jnp.ndarray, k: int) -> jnp.ndarray:
    """[N, W] packed uint32 -> [N, k] 2-bit codes (uint32)."""
    N, W = words.shape
    assert W == num_words(k)
    cols = []
    for pos in range(k):
        w, j = divmod(pos, BASES_PER_WORD)
        shift = jnp.uint32(2 * (BASES_PER_WORD - 1 - j))
        cols.append((words[:, w] >> shift) & jnp.uint32(3))
    return jnp.stack(cols, axis=1)


def _mmer_at(wcols: list, k: int, m: int, j: int) -> jnp.ndarray:
    """m-mer starting at base j, stitched from packed word columns ([N])."""
    a, r = divmod(j, BASES_PER_WORD)
    if r == 0:
        v = wcols[a]
    else:
        v = wcols[a] << jnp.uint32(2 * r)
        if a + 1 < len(wcols) and r + m > BASES_PER_WORD:
            v = v | (wcols[a + 1] >> jnp.uint32(32 - 2 * r))
    return v >> jnp.uint32(2 * (BASES_PER_WORD - m))


def signatures_from_words(words: jnp.ndarray, k: int, m: int) -> jnp.ndarray:
    """Minimizer signature of each packed k-mer row ([N] uint32).

    Written as a statically-unrolled chain of [N]-shaped elementwise ops
    (stitch + analytic norm + min per window) so XLA fuses the whole
    computation into one pass — materializing [N, k] unpacked-code or
    [N, k-m+1] norm matrices costs ~30x the HBM traffic.
    """
    wcols = [words[:, w] for w in range(words.shape[1])]
    sig = None
    for j in range(k - m + 1):
        nv = jbits.norm_mmers(_mmer_at(wcols, k, m, j), m)
        sig = nv if sig is None else jnp.minimum(sig, nv)
    return sig


def bins_from_words(words: jnp.ndarray, k: int, m: int, B: int) -> jnp.ndarray:
    """Bin id of each packed k-mer row ([N] int32)."""
    return jbits.hash_to_bucket(signatures_from_words(words, k, m), B)
