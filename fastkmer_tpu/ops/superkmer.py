"""Super-k-mer grouping and expansion — transport compression for the
bin exchange.

The reference emits maximal runs of consecutive k-mers sharing one
minimizer signature as single packed super-k-mers (``getSuperKmers``,
SparkBinKmerCounter.scala:34-169) because shuffling ``run + k - 1`` bases
is far cheaper than shuffling ``run`` full k-mers.  The same economics hold
for device all-to-alls, so this design reproduces the super-k-mer as a
*fixed-width record*:

    payload: SMAX bases packed in SMAX/16 uint32 words
    n_kmers: run length (<= SMAX - k + 1)
    bin:     the shared signature's bin

Runs are detected with one vectorized signature-change scan; runs longer
than ``SMAX - k + 1`` k-mers are force-split (the analogous forced flush in
the reference is the x+1 run cap on the reduce side, :495-503) — splitting
never changes counts because both halves keep the same signature and bin.

``expand`` re-materializes canonical k-mer words from received payloads by
static bit-stitching — the array equivalent of the reference's sub-k-mer
extraction constructor (``Kmer.readFromKmer``, package.scala:174-295,
"the hairiest code in the repo") including its reverse-complement path,
but with no per-object control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import jbits
from ..core.bits import BASES_PER_WORD, num_words
from . import windows
from .extract import Extracted

_U = jnp.uint32


class SuperKmers(NamedTuple):
    """Per-position super-k-mer starts, flattened over (read, position).

    payload:  [N, PW] uint32 packed bases (PW = smax/16)
    n_kmers:  [N] int32 run length (0 where not a start / invalid)
    bins:     [N] int32 shared bin
    is_start: [N] bool this position starts a super-k-mer
    """

    payload: jnp.ndarray
    n_kmers: jnp.ndarray
    bins: jnp.ndarray
    is_start: jnp.ndarray


def payload_words(smax: int) -> int:
    assert smax % BASES_PER_WORD == 0, "smax must be a multiple of 16"
    return smax // BASES_PER_WORD


def group(codes: jnp.ndarray, k: int, m: int, B: int,
          smax: int) -> tuple[SuperKmers, Extracted]:
    """Detect super-k-mer runs over a [R, L] code batch.

    Returns (SuperKmers, Extracted) — the Extracted is the underlying
    per-position view (shared work), letting callers choose per-k-mer or
    super-k-mer transport from one extraction pass.
    """
    from . import extract as ex_mod

    R, L = codes.shape
    P = L - k + 1
    cap = smax - k + 1  # max k-mers per record
    assert cap >= 1
    ex = ex_mod.extract(codes, k, m, B)
    sigs = ex.sigs.reshape(R, P)
    valid = ex.valid.reshape(R, P)
    bins2 = ex.bins.reshape(R, P)

    first = jnp.ones((R, 1), dtype=bool)
    sig_change = jnp.concatenate([first, sigs[:, 1:] != sigs[:, :-1]], axis=1)
    val_change = jnp.concatenate([first, valid[:, 1:] != valid[:, :-1]], axis=1)
    boundary = sig_change | val_change

    # force a boundary when a run would exceed cap: distance since the last
    # natural boundary, via cummax over boundary positions
    idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], (R, P))
    last_boundary = jax.lax.cummax(jnp.where(boundary, idx, 0), axis=1)
    dist = idx - last_boundary
    boundary = boundary | ((dist % cap == 0) & (dist > 0))

    is_start = boundary & valid

    # run length: next boundary position - own position (suffix cummin)
    bpos = jnp.where(boundary, idx, jnp.int32(P))
    nxt = jnp.flip(
        jax.lax.cummin(
            jnp.flip(
                jnp.concatenate([bpos[:, 1:], jnp.full((R, 1), P, jnp.int32)], axis=1), axis=1
            ),
            axis=1,
        ),
        axis=1,
    )
    n_kmers = jnp.where(is_start, nxt - idx, 0)

    # payload: the next smax bases packed, for every position (slices only)
    PW = payload_words(smax)
    pad = smax + BASES_PER_WORD
    extc = jnp.pad(codes, ((0, 0), (0, pad)), constant_values=4)
    codes2 = (extc & jnp.uint8(3)).astype(_U)
    p16 = windows.rolling_pack(codes2, 16)  # [R, L+pad-15]
    payload = jnp.stack(
        [p16[:, 16 * w : 16 * w + P] for w in range(PW)], axis=-1
    )  # [R, P, PW]

    n = R * P
    sk = SuperKmers(
        payload=payload.reshape(n, PW),
        n_kmers=n_kmers.reshape(n),
        bins=bins2.reshape(n),
        is_start=is_start.reshape(n),
    )
    return sk, ex


def _stitch(payload: jnp.ndarray, base_off: int, nbases: int, PW: int) -> jnp.ndarray:
    """Extract ``nbases`` bases starting at static offset ``base_off`` from
    [N, PW] packed payload rows as one big-endian uint32 (low-padded)."""
    a, r = divmod(base_off, BASES_PER_WORD)
    s = _U(2 * r)
    hi = payload[:, a] << s if r else payload[:, a]
    if r and a + 1 < PW:
        hi = hi | (payload[:, a + 1] >> _U(32 - 2 * r))
    if nbases < BASES_PER_WORD:
        hi = hi & _U(0xFFFFFFFF ^ ((1 << (2 * (BASES_PER_WORD - nbases))) - 1))
    return hi


def expand(payload: jnp.ndarray, n_kmers: jnp.ndarray, bins: jnp.ndarray, k: int, smax: int):
    """[S, PW] payloads -> canonical k-mer words [S, C, W], valid [S, C],
    bins [S, C]  (C = smax - k + 1 static slots, slot j valid iff
    j < n_kmers).  Canonicalization matches extract.extract exactly."""
    S, PW = payload.shape
    assert PW == payload_words(smax)
    C = smax - k + 1
    W = num_words(k)
    rem = k - BASES_PER_WORD * (W - 1)

    # reverse-complement payload: rp[i] = RC of payload bases, such that
    # RC-substring extraction is a forward stitch on rp at mirrored offset
    comp = payload ^ _U(0xFFFFFFFF)
    rp = jnp.stack(
        [jbits.reverse16(comp[:, PW - 1 - w]) for w in range(PW)], axis=1
    )  # rp word w' holds RC bases [16w', 16w'+16) of the smax-length RC string

    fwd_all = []
    rc_all = []
    for j in range(C):
        fwd = []
        for w in range(W):
            nb = rem if w == W - 1 else BASES_PER_WORD
            fwd.append(_stitch(payload, j + 16 * w, nb, PW))
        # RC of bases [j, j+k) = RC-string bases [smax-j-k, smax-j)
        roff = smax - j - k
        rc = []
        for w in range(W):
            nb = rem if w == W - 1 else BASES_PER_WORD
            rc.append(_stitch(rp, roff + 16 * w, nb, PW))
        fwd_all.append(fwd)
        rc_all.append(rc)

    per_j = []
    for j in range(C):
        use_rc = jnp.zeros(S, dtype=bool)
        decided = jnp.zeros(S, dtype=bool)
        for w in range(W):
            lt = rc_all[j][w] < fwd_all[j][w]
            gt = rc_all[j][w] > fwd_all[j][w]
            use_rc = use_rc | (~decided & lt)
            decided = decided | lt | gt
        per_j.append(
            jnp.stack(
                [jnp.where(use_rc, rc_all[j][w], fwd_all[j][w]) for w in range(W)], axis=-1
            )
        )
    words = jnp.stack(per_j, axis=1)  # [S, C, W]

    slot = jnp.arange(C, dtype=jnp.int32)[None, :]
    valid = slot < n_kmers[:, None]
    bins_out = jnp.broadcast_to(bins[:, None], (S, C))
    return words, valid, bins_out
