"""Host-side (numpy) bit-level genomic core.

This is the framework's equivalent of the reference's bit-level core
(reference: src/main/scala/skc/package.scala:17-135, 686-754), re-designed
array-first: instead of a ``Kmer`` object graph, sequences are flat numpy
arrays of 2-bit codes and k-mers are tuples of big-endian packed uint32
words.  These functions are the *semantic source of truth* used by ingest,
output decoding and the test oracles; the device (jnp) versions in
``core.jbits`` are tested against them.

Representation choices (differ deliberately from the reference's
31-bases-per-Long right-aligned packing, package.scala:17,138-503):

* bases are 2-bit codes A=0 C=1 G=2 T=3; anything else (N, lowercase, ...)
  is the invalid code 4 — mirroring ``notANucleotide`` semantics
  (package.scala:697) where any non-ACGT uppercase char splits reads.
* a k-mer is ``W = ceil(k/16)`` uint32 words; base 0 (leftmost) sits in the
  highest bits of word 0; the last word is zero-padded in its LOW bits, so
  lexicographic string order == numeric order of the word tuple.  This is
  what makes ``jax.lax.sort(num_keys=W)`` a correct k-mer comparator on the device
  (the reference instead compares packed Longs, package.scala:389-404).
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16  # 2 bits/base in a uint32
INVALID_CODE = 4

# ASCII -> 2-bit code lookup (256 entries); invalid = 4.
# Mirrors nucleotideBitmasks (package.scala:18-22) + notANucleotide (:697).
ASCII_TO_CODE = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    ASCII_TO_CODE[_ch] = _code

# 2-bit code -> ASCII char (package.scala:24-34)
CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

COMPLEMENT = np.array([3, 2, 1, 0, INVALID_CODE], dtype=np.uint8)


def encode_ascii(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (invalid chars -> 4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    codes = np.asarray(codes, dtype=np.uint8)
    if np.any(codes >= 4):
        raise ValueError("cannot decode invalid codes")
    return CODE_TO_ASCII[codes].tobytes().decode()


def reverse_complement_int(v: int, length: int) -> int:
    """RC of a 2-bit-packed integer m-mer (reference: package.scala:103-115)."""
    rev = 0
    for _ in range(length):
        rev = (rev << 2) | (3 - (v & 3))
        v >>= 2
    return rev


def is_allowed(mmer: int, length: int) -> bool:
    """KMC2 signature filter (reference: package.scala:46-75).

    The reference's checks (AA-pair at any position >= 2, AAA prefix, ACA
    prefix, AA* prefix, *AA prefix) reduce exactly to: the m-mer contains no
    "AA" substring and does not start with "ACA".
    """
    for j in range(length - 1):  # adjacent pair starting at string pos j
        shift = 2 * (length - 2 - j)
        if (mmer >> shift) & 0xF == 0:
            return False
    if length >= 3 and (mmer >> (2 * (length - 3))) == 0b000100:
        return False  # ACA prefix
    return True


def fill_norm(m: int) -> np.ndarray:
    """Norm table: norm[v] = min(v if allowed else S, rc(v) if allowed else S)
    with sentinel S = 4^m (reference: package.scala:77-100).  Vectorized.
    """
    if not (2 <= m <= 15):
        raise ValueError("m must be in [2, 15]")
    n = 1 << (2 * m)
    v = np.arange(n, dtype=np.uint32)
    rc = rc_mmers(v, m)
    ok_v = allowed_mask(v, m)
    ok_rc = allowed_mask(rc, m)
    sval = np.where(ok_v, v, np.uint32(n))
    rval = np.where(ok_rc, rc, np.uint32(n))
    return np.minimum(sval, rval).astype(np.uint32)


def rc_mmers(v: np.ndarray, m: int) -> np.ndarray:
    """Vectorized RC of 2-bit-packed m-mers held in uint32 (m <= 15)."""
    x = v.astype(np.uint32) ^ np.uint32((1 << (2 * m)) - 1)  # complement
    # reverse the 16 2-bit fields of the 32-bit word
    x = ((x & np.uint32(0x33333333)) << np.uint32(2)) | ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((x >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
    x = ((x & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((x >> np.uint32(8)) & np.uint32(0x00FF00FF))
    x = (x << np.uint32(16)) | (x >> np.uint32(16))
    return x >> np.uint32(32 - 2 * m)


def allowed_mask(v: np.ndarray, m: int) -> np.ndarray:
    """Vectorized is_allowed over packed m-mers (semantics of package.scala:46-75)."""
    v = v.astype(np.uint32)
    y = v | (v >> np.uint32(2))
    # low bit of each 2-bit field of y is set iff that field != 0
    t = (y | (y >> np.uint32(1))) & np.uint32(0x55555555)
    # fields 0..m-2 of y are the m-1 adjacent pairs
    pairmask = np.uint32(0x55555555) & np.uint32((1 << (2 * (m - 1))) - 1)
    no_aa = (t & pairmask) == pairmask
    if m >= 3:
        not_aca = (v >> np.uint32(2 * m - 6)) != np.uint32(0b000100)
    else:
        not_aca = np.ones_like(no_aa)
    return no_aa & not_aca


def hash_to_bucket(s, B: int):
    """Signature -> bin hash (reference: package.scala:686-695).

    Bit-exact replica of the int32 xorshift/multiply avalanche; operating in
    uint32 reproduces JVM signed-int wraparound and ``>>>`` exactly.
    Accepts scalars or arrays.
    """
    key = np.asarray(s, dtype=np.uint32)
    with np.errstate(over="ignore"):
        key = (key ^ np.uint32(61)) ^ (key >> np.uint32(16))
        key = key + (key << np.uint32(3))
        key = key ^ (key >> np.uint32(4))
        key = key * np.uint32(0x27D4EB2D)
        key = key ^ (key >> np.uint32(15))
    out = (key & np.uint32(0x7FFFFFFF)) % np.uint32(B)
    return out.astype(np.int32) if out.ndim else int(out)


def num_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


def pack_kmer_words(codes: np.ndarray, k: int) -> tuple[int, ...]:
    """Pack k codes into W big-endian uint32 words (last word low-padded)."""
    codes = np.asarray(codes, dtype=np.uint64)
    assert codes.shape[0] == k and np.all(codes < 4)
    W = num_words(k)
    words = []
    for w in range(W):
        val = 0
        for j in range(BASES_PER_WORD):
            pos = w * BASES_PER_WORD + j
            b = int(codes[pos]) if pos < k else 0
            val = (val << 2) | b
        words.append(val & 0xFFFFFFFF)
    return tuple(words)


def unpack_kmer_words(words, k: int) -> np.ndarray:
    """Inverse of pack_kmer_words -> uint8 codes of length k."""
    out = np.empty(k, dtype=np.uint8)
    for pos in range(k):
        w, j = divmod(pos, BASES_PER_WORD)
        shift = 2 * (BASES_PER_WORD - 1 - j)
        out[pos] = (int(words[w]) >> shift) & 3
    return out


def words_to_str(words, k: int) -> str:
    return decode_codes(unpack_kmer_words(words, k))


def decode_words_batch(words: np.ndarray, k: int) -> list[bytes]:
    """Vectorized decode of [N, W] uint32 word rows -> list of ASCII k-mers.

    Replaces the reference's per-Kmer toByteArray loop (package.scala:416-454)
    with one table lookup over an [N, k] code matrix.
    """
    words = np.asarray(words, dtype=np.uint32)
    N, W = words.shape
    assert W == num_words(k)
    pos = np.arange(k)
    widx = pos // BASES_PER_WORD
    shift = (2 * (BASES_PER_WORD - 1 - pos % BASES_PER_WORD)).astype(np.uint32)
    codes = (words[:, widx] >> shift[None, :]) & np.uint32(3)
    ascii_mat = CODE_TO_ASCII[codes]
    flat = ascii_mat.tobytes()
    return [flat[i * k:(i + 1) * k] for i in range(N)]
