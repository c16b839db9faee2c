"""Scalar (pure-Python) primitives of the SuperSampler data model.

These are the bit-exact scalar definitions of every primitive the device
pipeline vectorizes. They serve three roles:
  1. spec: the single place each operation's semantics is written down,
  2. oracle: tests check the JAX/Pallas kernels against these,
  3. host finisher: the tiny tail of work done on host (bucket
     serialization, CSV formatting) reuses them directly.

Semantics follow the reference implementation (cited per function); all
integer math is mod 2^64 (or 2^128 for k-mers) like the C++ types.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1

# XXHash64 primes (reference include/xxhash64.h:167-171).
PRIME1 = 11400714785074694791
PRIME2 = 14029467366897019727
PRIME3 = 1609587929392839161
PRIME4 = 9650029242287828579
PRIME5 = 2870177450012600261

#: The one hash seed used everywhere (reference utils.cpp:248).
SEED = 1312

# 2-bit nucleotide code: A=0, C=1, T=2, G=3 (reference utils.cpp:13-16).
NUC2INT = {"A": 0, "C": 1, "T": 2, "G": 3}
INT2NUC = "ACTG"

# char -> code lookup over all 256 byte values, matching (c/2)%4
# (reference utils.cpp:13-16 applies to arbitrary chars; only ACGT occur
# after clean_dna).
NUC2INT_LUT = np.array([(c // 2) % 4 for c in range(256)], dtype=np.uint8)


def rotl64(x: int, r: int) -> int:
    x &= MASK64
    return ((x << r) | (x >> (64 - r))) & MASK64


def xxhash64_u64(x: int, seed: int = SEED) -> int:
    """XXHash64 of the 8 little-endian bytes of ``x``.

    Specialization of the general algorithm for an 8-byte input
    (reference include/xxhash64.h:100-150 with totalLength == 8 < 32:
    result = seed + Prime5 + 8, one 8-byte round, final avalanche).
    """
    h = (seed + PRIME5 + 8) & MASK64
    single = rotl64((x * PRIME2) & MASK64, 31) * PRIME1 & MASK64
    h = (rotl64(h ^ single, 27) * PRIME1 + PRIME4) & MASK64
    h ^= h >> 33
    h = (h * PRIME2) & MASK64
    h ^= h >> 29
    h = (h * PRIME3) & MASK64
    h ^= h >> 32
    return h


def unrevhash(x: int) -> int:
    """Minimizer ordering/selection hash (reference utils.cpp:244-249)."""
    return xxhash64_u64(x, SEED)


def nuc2int(c: str) -> int:
    """(c/2)%4 on the ASCII value (reference utils.cpp:13-16)."""
    return (ord(c) // 2) % 4


def nuc2intrc(c: str) -> int:
    """Complement of the 2-bit code = code^2 (reference utils.cpp:20-22)."""
    return ((ord(c) // 2) % 4) ^ 2


def int2nuc(n: int) -> str:
    return INT2NUC[n]


def str2num(s: str) -> int:
    """Pack a DNA string into a big-endian 2-bit integer
    (reference utils.cpp:158-165)."""
    res = 0
    for ch in s:
        res = (res << 2) | ((ord(ch) // 2) % 4)
    return res


# ACGT -> base-4 digits for the fast path below; other bytes never occur
# after clean_dna (utils.cpp:675-702 strips them before any packing).
_TO_BASE4 = str.maketrans("ACTG", "0123")


def str2num_fast(s: str) -> int:
    """str2num for cleaned (ACGT-only) strings: one C-level base-4 parse
    instead of a Python loop per nucleotide."""
    return int(s.translate(_TO_BASE4), 4) if s else 0


def num2str(num: int, k: int) -> str:
    """Unpack ``k`` nucleotides (reference utils.cpp:168-183)."""
    out = []
    for _ in range(k):
        out.append(INT2NUC[num & 3])
        num >>= 2
    return "".join(reversed(out))


def revcomp_code(x: int, n: int) -> int:
    """Reverse complement of an n-mer 2-bit code.

    Equivalent to the byteswap+swizzle bit tricks rcbc/rcb
    (reference utils.cpp:449-462 and 397-438) for any n.
    """
    rc = 0
    for _ in range(n):
        rc = (rc << 2) | ((x & 3) ^ 2)
        x >>= 2
    return rc


def canonize(x: int, n: int) -> int:
    """min(x, revcomp(x)) (reference utils.cpp:465-472)."""
    return min(x, revcomp_code(x, n))


_COMP_TABLE = str.maketrans(
    {c: {"A": "T", "C": "G", "G": "C", "T": "A"}.get(c, "A")
     for c in map(chr, range(256))})


def revcomp_str(s: str) -> str:
    """String reverse complement; non-ACGT maps to 'A'
    (reference utils.cpp:131-148)."""
    return s.translate(_COMP_TABLE)[::-1]


def str_compressor(s: str) -> bytes:
    """2-bit packer for sketch blobs (reference utils.cpp:48-68).

    Layout: one mod byte (len % 4), then big-endian-within-byte packed
    nucleotides; a trailing partial byte is left-shifted one extra time
    (the reference shifts after every append, including the last).
    The reference's accumulator is uninitialized; observed behavior of
    the compiled binaries is 0, which we pin here.
    """
    if not s:
        return b""
    mod = len(s) % 4
    out = bytearray([mod])
    codes = NUC2INT_LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
    nfull = len(s) // 4
    if nfull:
        g = codes[: 4 * nfull].reshape(-1, 4).astype(np.uint8)
        out += ((g[:, 0] << 6) | (g[:, 1] << 4) | (g[:, 2] << 2)
                | g[:, 3]).tobytes()
    if mod != 0:
        # the reference shifts after every append, including the last,
        # so the partial byte carries one extra <<2
        c = 0
        for v in codes[4 * nfull:]:
            c = ((c | int(v)) << 2) & 0xFF
        out.append(c)
    return bytes(out)


def str_decompressor(b: bytes) -> str:
    """Inverse of :func:`str_compressor` (reference utils.cpp:71-111)."""
    if not b:
        return ""
    mod = b[0]
    last = len(b) if mod == 0 else len(b) - 1
    out = []
    for i in range(1, last):
        p = b[i]
        out.append(INT2NUC[(p >> 6) & 3])
        out.append(INT2NUC[(p >> 4) & 3])
        out.append(INT2NUC[(p >> 2) & 3])
        out.append(INT2NUC[p & 3])
    if mod != 0:
        p = b[last]
        # The partial byte was shifted one extra time; nucleotide j sits
        # at bit offset 2*(mod - j) from the LSB (reference utils.cpp:100-108).
        chars = []
        for i in range(mod + 1):
            chars.append(INT2NUC[p & 3])
            p >>= 2
        chars.reverse()  # chars[0] is the highest -> fchar[0..mod]
        out.extend(chars[:mod])
    return "".join(out)


def compute_threshold(k: int, m: int, sampling_rate: float) -> int:
    """FHS selection threshold (reference SubSampler.cpp:622-631).

    t = uint64((1 - (1 - 1/s)^(1/(k-m+1))) * 2^63) * 2, computed in
    80-bit long double exactly as the C++ (verified against the
    reference's compiled compute_threshold: glibc powl at runtime).
    s <= 1 selects everything (selection_threshold = (uint64_t)-1,
    reference SubSampler.h:79-83).
    """
    if sampling_rate <= 1:
        return MASK64
    from supersampler_tpu.native import threshold_native

    t = threshold_native(k, m, sampling_rate)
    if t is not None:
        return t
    # np.power on longdouble calls glibc powl: bit-identical fallback.
    ld = np.longdouble
    mmerinkmer = ld(k - m + 1)
    fraction = ld(1) / ld(sampling_rate)
    root = np.power(ld(1) - fraction, ld(1) / mmerinkmer)
    result = (ld(1) - root) * ld(1 << 63)
    return (int(result) * 2) & MASK64


def parse_rate_arg(s: str) -> float:
    """The reference parses -s with stof (32-bit float) into a double
    (reference SubSampler.cpp:698-699); replicate the float32 rounding."""
    return float(np.float32(s))


def format_double(x: float) -> str:
    """std::to_string(double): printf %f with 6 decimals."""
    return f"{x:.6f}"


def format_g6(x: float, precision: int = 6) -> str:
    """C++ ostream default float format with setprecision(p) == %.{p}g."""
    return f"{x:.{precision}g}"


def int_to_string(n: int) -> str:
    """Thousands-separated formatting (reference utils.cpp:115-127)."""
    if n < 1000:
        return str(n)
    end = str(n % 1000)
    if len(end) == 3:
        return int_to_string(n // 1000) + "," + end
    if len(end) == 2:
        return int_to_string(n // 1000) + ",0" + end
    return int_to_string(n // 1000) + ",00" + end
