"""Device-side (jax.numpy) bit-level core.

Device re-design of the reference's norm-table / hash / RC machinery
(reference: src/main/scala/skc/package.scala:46-135, 686-695): instead of a
4^m-entry table gather per position (``Mmer.insert`` -> ``norm(_data)``,
package.scala:552-558), the canonical+allowed "norm" of every m-mer is
computed *analytically* with ~15 elementwise bit-ops, which fuse with the
rest of the stage-1 pipeline under XLA instead of a random gather into a
4 MB table.

All functions are shape-polymorphic elementwise over uint32 arrays and are
verified bit-exact against the numpy versions in ``core.bits``.
"""

from __future__ import annotations

import jax.numpy as jnp

U = jnp.uint32


def _u(x):
    return jnp.uint32(x)


def rc_mmers(v: jnp.ndarray, m: int) -> jnp.ndarray:
    """Reverse-complement of 2-bit-packed m-mers (m <= 15) held in uint32."""
    x = v.astype(U) ^ _u((1 << (2 * m)) - 1)
    x = ((x & _u(0x33333333)) << _u(2)) | ((x >> _u(2)) & _u(0x33333333))
    x = ((x & _u(0x0F0F0F0F)) << _u(4)) | ((x >> _u(4)) & _u(0x0F0F0F0F))
    x = ((x & _u(0x00FF00FF)) << _u(8)) | ((x >> _u(8)) & _u(0x00FF00FF))
    x = (x << _u(16)) | (x >> _u(16))
    return x >> _u(32 - 2 * m)


def allowed_mask(v: jnp.ndarray, m: int) -> jnp.ndarray:
    """KMC2 allowed filter: no "AA" substring, no "ACA" prefix
    (semantics of reference package.scala:46-75)."""
    v = v.astype(U)
    y = v | (v >> _u(2))
    t = (y | (y >> _u(1))) & _u(0x55555555)
    pairmask = _u(0x55555555 & ((1 << (2 * (m - 1))) - 1))
    no_aa = (t & pairmask) == pairmask
    if m >= 3:
        not_aca = (v >> _u(2 * m - 6)) != _u(0b000100)
        return no_aa & not_aca
    return no_aa


def norm_mmers(v: jnp.ndarray, m: int) -> jnp.ndarray:
    """norm(v) = min(v if allowed else 4^m, rc(v) if allowed else 4^m).

    Fused analytic equivalent of the reference norm-table lookup
    (fillNorm, package.scala:77-100).
    """
    sentinel = _u(1 << (2 * m))
    rc = rc_mmers(v, m)
    sval = jnp.where(allowed_mask(v, m), v.astype(U), sentinel)
    rval = jnp.where(allowed_mask(rc, m), rc, sentinel)
    return jnp.minimum(sval, rval)


def hash_to_bucket(s: jnp.ndarray, B: int) -> jnp.ndarray:
    """Bit-exact signature->bin hash (reference: package.scala:686-695)."""
    key = s.astype(U)
    key = (key ^ _u(61)) ^ (key >> _u(16))
    key = key + (key << _u(3))
    key = key ^ (key >> _u(4))
    key = key * _u(0x27D4EB2D)
    key = key ^ (key >> _u(15))
    return ((key & _u(0x7FFFFFFF)) % _u(B)).astype(jnp.int32)


def reverse16(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit fields of each uint32 (no complement)."""
    x = x.astype(U)
    x = ((x & _u(0x33333333)) << _u(2)) | ((x >> _u(2)) & _u(0x33333333))
    x = ((x & _u(0x0F0F0F0F)) << _u(4)) | ((x >> _u(4)) & _u(0x0F0F0F0F))
    x = ((x & _u(0x00FF00FF)) << _u(8)) | ((x >> _u(8)) & _u(0x00FF00FF))
    return (x << _u(16)) | (x >> _u(16))
