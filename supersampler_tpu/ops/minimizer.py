"""Vectorized minimizer scan: the compute core of sketch construction.

The reference's per-nucleotide streaming loop (reference
SubSampler.cpp:367-440) is an inherently sequential state machine, but
its state has bounded memory: an *event* (minimizer adoption when a new
m-mer hash beats the current one, or a rescan when the minimizer
expires, SubSampler.cpp:374-399) occurs at least every k-m+1 positions,
and the post-event state is a pure function of the event's position and
type. We therefore:

 1. compute every per-position quantity in parallel (rolling m-mer
    codes, canonical forms, XXHash64 hashes, per-window elections with
    the exact regular_minimizer_pos tie-breaking,
    SubSampler.cpp:81-169);
 2. build *successor tables*: for each position j and event type
    (adopt/rescan), the position and type of the next event — a local
    computation looking at most k-m+1 positions ahead;
 3. extract the event chain by following successors (host walker or
    jit block-walk); every event is a super-k-mer boundary
    (adoption strictly lowers the hash => changes the minimizer;
    rescans force a boundary via the reference's `dump` flag,
    SubSampler.cpp:401).

All 64-bit hash math runs as uint32 limb pairs (ops/u64.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from supersampler_tpu.ops import u64 as U
from supersampler_tpu.ops.hashing import xxh64_u32

_I32 = jnp.int32
_U32 = jnp.uint32


class ScanTables(NamedTuple):
    """Device outputs: everything the chain walker needs.

    Arrays indexed by loop position i in [0, n_loop) unless noted;
    n_loop = P - k for padded length P (valid region is i <= L-k-1).
    """

    # successor tables, per event type (A=adoption, R=rescan):
    nxt_pos_a: jnp.ndarray   # int32, next event position or -1
    nxt_adopt_a: jnp.ndarray  # bool, next event is an adoption
    nxt_pos_r: jnp.ndarray
    nxt_adopt_r: jnp.ndarray
    # dense per-position event payloads (state set by an event there):
    val_a: jnp.ndarray       # uint32 minimizer value if adoption at i
    rev_a: jnp.ndarray       # bool strand
    sel_a: jnp.ndarray       # bool unrevhash(minimizer) <= threshold
    val_r: jnp.ndarray       # same for rescan at i (election of window i+1)
    rev_r: jnp.ndarray
    sel_r: jnp.ndarray
    # initial state (election of window 0): [next_pos, next_adopt,
    # val, rev, sel] packed as scalars
    init_nxt_pos: jnp.ndarray
    init_nxt_adopt: jnp.ndarray
    init_val: jnp.ndarray
    init_rev: jnp.ndarray
    init_sel: jnp.ndarray


def rolling_mmers(codes: jnp.ndarray, m: int, n_out: int):
    """Forward/RC m-mer codes at every start position s in [0, n_out).

    codes: uint8/uint32 2-bit codes, length >= n_out + m - 1.
    Returns (fwd, rc) uint32 arrays; 2m <= 30 bits fits uint32.
    """
    codes = codes.astype(_U32)
    fwd = jnp.zeros((n_out,), _U32)
    rc = jnp.zeros((n_out,), _U32)
    for j in range(m):
        c = jax.lax.dynamic_slice(codes, (j,), (n_out,))
        fwd = (fwd << 2) | c
        rc = rc | ((c ^ 2) << (2 * j))
    return fwd, rc


def window_elections(canon: jnp.ndarray, rev: jnp.ndarray, hh: U.U64,
                     k: int, m: int, n_w: int):
    """Exact regular_minimizer_pos (reference SubSampler.cpp:81-169) for
    every window w in [0, n_w), folding m-mers right-to-left.

    canon/rev/hash are indexed by m-mer start position (length >=
    n_w + k - m). Returns (EM value u32, EP rel position i32, ER bool,
    EH hash).
    """
    W = k - m + 1

    def sl(a, off):
        return jax.lax.dynamic_slice(a, (off,), (n_w,))

    def slh(h, off):
        return U.U64(sl(h.hi, off), sl(h.lo, off))

    # i = 0: rightmost m-mer (offset k-m)
    mini = sl(canon, k - m)
    is_rev = sl(rev, k - m)
    pos = jnp.where(is_rev, 0, k - m).astype(_I32)
    hmin = slh(hh, k - m)
    for i in range(1, W):
        off = k - m - i
        mmer = sl(canon, off)
        local_rev = sl(rev, off)
        h = slh(hh, off)
        replace = U.gt(hmin, h)
        tie = (mmer == mini) & ~replace
        same_dir = tie & (local_rev == is_rev)
        # reference tie rules: rev minimizers prefer larger i -> pos=i;
        # fwd prefer leftmost -> pos=k-m-i (SubSampler.cpp:149-165)
        tie_take = same_dir & jnp.where(is_rev, pos > i, pos > (k - m - i))
        take = replace | tie_take
        new_pos = jnp.where(replace, k - m - i,
                            jnp.where(is_rev, i, k - m - i)).astype(_I32)
        pos = jnp.where(take, new_pos, pos)
        mini = jnp.where(take, mmer, mini)
        is_rev = jnp.where(take, local_rev, is_rev)
        hmin = U.where(take, h, hmin)
    return mini, pos, is_rev, hmin


def _succ_table(h: U.U64, p: jnp.ndarray, j: jnp.ndarray,
                h_enter_pad: U.U64, W: int, last_i: jnp.ndarray):
    """Next event after an event at position j leaving state (h, p).

    The next event is the first i > j with H_enter[i] < h (adoption,
    checked first at every position, SubSampler.cpp:374) and otherwise
    the rescan at i == p (SubSampler.cpp:391). p - j <= W always.
    """
    n = j.shape[0]
    neg1 = jnp.full((n,), -1, _I32)
    best_pos = neg1
    best_adopt = jnp.zeros((n,), bool)
    found = jnp.zeros((n,), bool)
    for w in range(1, W + 1):
        i = j + w
        hi = U.U64(jax.lax.dynamic_slice(h_enter_pad.hi, (w,), (n,)),
                   jax.lax.dynamic_slice(h_enter_pad.lo, (w,), (n,)))
        adopt = (i <= p) & U.lt(hi, h) & (i <= last_i)
        rescan = (i == p) & ~U.lt(hi, h) & (i <= last_i)
        ev = adopt | rescan
        take = ev & ~found
        best_pos = jnp.where(take, i, best_pos)
        best_adopt = jnp.where(take, adopt, best_adopt)
        found = found | ev
    return best_pos, best_adopt


def scan_tables(codes: jnp.ndarray, k: int, m: int, padded_len: int,
                length: jnp.ndarray, threshold: U.U64) -> ScanTables:
    """Full vectorized scan of one 2-bit-coded sequence (pure function;
    vmap/shard_map-safe — see parallel/mesh.py for the batched form).

    codes: uint8 array of size padded_len (>= length + small margin).
    length: actual sequence length (int32 scalar).
    Returns ScanTables for the host/native chain walker.
    """
    P = padded_len
    W = k - m + 1
    n_m = P - m + 1       # m-mer start positions
    n_loop = P - k        # streaming loop positions
    n_w = P - k + 1       # k-mer windows

    fwd, rc = rolling_mmers(codes, m, n_m)
    canon = jnp.minimum(fwd, rc)
    rev = rc < fwd
    hh = xxh64_u32(canon)

    em, ep, er, eh = window_elections(canon, rev, hh, k, m, n_w)

    # Per-loop-position entering m-mer (starts at i + k - m + 1).
    def ent(a):
        return jax.lax.dynamic_slice(a, (k - m + 1,), (n_loop,))

    c_ent = ent(canon)
    r_ent = ent(rev)
    h_ent = U.U64(ent(hh.hi), ent(hh.lo))

    last_i = (length - k - 1).astype(_I32)
    j_idx = jnp.arange(n_loop, dtype=_I32)

    # Padded entering-hash array for lookahead slices: index by j + w.
    ones = jnp.full((W,), 0xFFFFFFFF, _U32)
    h_ent_pad = U.U64(jnp.concatenate([h_ent.hi, ones]),
                      jnp.concatenate([h_ent.lo, ones]))

    def h_ent_pad_from(j0):
        return U.U64(jax.lax.dynamic_slice(h_ent_pad.hi, (j0,),
                                           (n_loop + W,)),
                     jax.lax.dynamic_slice(h_ent_pad.lo, (j0,),
                                           (n_loop + W,)))

    # Adoption nodes: state (H_enter[j], p = j + W).
    pa = j_idx + W
    nxt_pos_a, nxt_adopt_a = _succ_table(h_ent, pa, j_idx, h_ent_pad, W,
                                         last_i)
    sel_a = U.le(h_ent, threshold)

    # Rescan nodes: election of window j+1; absolute position
    # p = EP[j+1] + j + 1 (the reference's position_min += (i+1),
    # SubSampler.cpp:397).
    em_r = jax.lax.dynamic_slice(em, (1,), (n_loop,))
    ep_r = jax.lax.dynamic_slice(ep, (1,), (n_loop,))
    er_r = jax.lax.dynamic_slice(er, (1,), (n_loop,))
    eh_r = U.U64(jax.lax.dynamic_slice(eh.hi, (1,), (n_loop,)),
                 jax.lax.dynamic_slice(eh.lo, (1,), (n_loop,)))
    pr = ep_r + j_idx + 1
    nxt_pos_r, nxt_adopt_r = _succ_table(eh_r, pr, j_idx, h_ent_pad, W,
                                         last_i)
    sel_r = U.le(eh_r, threshold)

    # Initial state: election of window 0, absolute position EP[0].
    init_h = U.U64(eh.hi[0:1], eh.lo[0:1])
    init_p = ep[0:1]
    init_j = jnp.full((1,), -1, _I32)
    init_pad = U.U64(h_ent_pad.hi[: 1 + W + 1], h_ent_pad.lo[: 1 + W + 1])
    # reuse _succ_table with a 1-element "array": lookahead slices need
    # h_ent_pad offset by j+w = w-1 -> build a shifted pad starting at -1.
    shift_pad = U.U64(
        jnp.concatenate([jnp.zeros((0,), _U32), h_ent_pad.hi]),
        jnp.concatenate([jnp.zeros((0,), _U32), h_ent_pad.lo]))
    neg1 = jnp.full((1,), -1, _I32)
    best_pos = neg1
    best_adopt = jnp.zeros((1,), bool)
    found = jnp.zeros((1,), bool)
    for w in range(1, W + 1):
        i = init_j + w  # = w - 1
        hi = U.U64(shift_pad.hi[w - 1: w], shift_pad.lo[w - 1: w])
        adopt = (i <= init_p) & U.lt(hi, init_h) & (i <= last_i)
        rescan = (i == init_p) & ~U.lt(hi, init_h) & (i <= last_i)
        ev = adopt | rescan
        take = ev & ~found
        best_pos = jnp.where(take, i, best_pos)
        best_adopt = jnp.where(take, adopt, best_adopt)
        found = found | ev

    return ScanTables(
        nxt_pos_a=nxt_pos_a, nxt_adopt_a=nxt_adopt_a,
        nxt_pos_r=nxt_pos_r, nxt_adopt_r=nxt_adopt_r,
        val_a=c_ent, rev_a=r_ent, sel_a=sel_a,
        val_r=em_r, rev_r=er_r, sel_r=sel_r,
        init_nxt_pos=best_pos[0], init_nxt_adopt=best_adopt[0],
        init_val=em[0], init_rev=er[0], init_sel=U.le(
            U.U64(eh.hi[0:1], eh.lo[0:1]), threshold)[0],
    )


device_scan = jax.jit(scan_tables, static_argnums=(1, 2, 3))


# ----------------------------------------------------------------------
# 2D-tiled variant: positions laid out as (R, C) rows with a halo of
# lookahead columns, so every shifted view is a static column slice of
# a 2D array. shift2d(a, d) equals the flat array shifted by d
# positions.
# ----------------------------------------------------------------------

def scan_tables_2d(codes: jnp.ndarray, k: int, m: int, padded_len: int,
                   length: jnp.ndarray, threshold: U.U64,
                   cols: int = 512) -> ScanTables:
    """2D-tiled scan, bit-identical to scan_tables.

    Positions are laid out as (R, cols) rows with halo = k + (k-m+1)
    extra lookahead columns copied from the next row; every shifted
    read is then a static 2D column slice (a zero-copy view inside XLA
    fusions), and all math runs on (8,128)-tileable arrays.

    codes: uint8 of size padded_len; padded_len must be a multiple of
    ``cols`` and at least length + halo + 1.
    """
    P = padded_len
    C = cols
    W = k - m + 1
    halo = k + W
    assert C > halo, (C, halo)
    assert P % C == 0
    R = P // C
    n_loop = P - k

    base = codes.reshape(R, C)
    c2 = jnp.concatenate(
        [base, jnp.roll(base, -1, axis=0)[:, :halo]],
        axis=1).astype(jnp.uint32)

    (na_pos, na_adopt, nr_pos, nr_adopt, c_ent, r_ent, sel_a, em_r, er_r,
     sel_r, em_full, ep_full, er_full, eh_full, h_ent0) = _block_tables(
        c2, 0, length, threshold, k, m, C, halo)

    def flat(a):
        return a.reshape(-1)[:n_loop]

    last_i = (length - k - 1).astype(_I32)

    # initial state: election of window 0 (scalar succ scan)
    em0 = em_full[0, 0]
    ep0 = ep_full[0, 0]
    er0 = er_full[0, 0]
    eh0 = U.U64(eh_full.hi[0:1, 0], eh_full.lo[0:1, 0])
    h_ent_flat = U.U64(h_ent0.hi[0], h_ent0.lo[0])  # first row, cols 0..W
    init_pos = jnp.full((1,), -1, _I32)
    init_adopt = jnp.zeros((1,), bool)
    init_found = jnp.zeros((1,), bool)
    p0 = ep0[None]
    for w in range(1, W + 1):
        i = jnp.full((1,), w - 1, _I32)
        hi = U.U64(h_ent_flat.hi[w - 1 : w], h_ent_flat.lo[w - 1 : w])
        ltv = U.lt(hi, eh0)
        adopt = (i <= p0) & ltv & (i <= last_i)
        rescan = (i == p0) & ~ltv & (i <= last_i)
        ev = adopt | rescan
        take = ev & ~init_found
        init_pos = jnp.where(take, i, init_pos)
        init_adopt = jnp.where(take, adopt, init_adopt)
        init_found = init_found | ev

    return ScanTables(
        nxt_pos_a=flat(na_pos), nxt_adopt_a=flat(na_adopt),
        nxt_pos_r=flat(nr_pos), nxt_adopt_r=flat(nr_adopt),
        val_a=flat(c_ent), rev_a=flat(r_ent), sel_a=flat(sel_a),
        val_r=flat(em_r), rev_r=flat(er_r), sel_r=flat(sel_r),
        init_nxt_pos=init_pos[0], init_nxt_adopt=init_adopt[0],
        init_val=em0, init_rev=er0,
        init_sel=U.le(eh0, threshold)[0],
    )


def unpack_2bit(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    """Expand a 2-bit-packed uint8 array (4 codes/byte, LSB-first like
    the host packer) to n uint8 codes."""
    u = packed.reshape(-1, 1).astype(jnp.uint32)
    shifts = jnp.array([0, 2, 4, 6], jnp.uint32).reshape(1, 4)
    return ((u >> shifts) & 3).astype(jnp.uint8).reshape(n)


def pack_2bit_np(codes: np.ndarray) -> np.ndarray:
    """Host-side 4x compaction of 2-bit codes for the H2D transfer
    (4x fewer bytes over the host-to-device link).

    One u32 pass: 4 little-endian code bytes c0..c3 OR-fold into
    c0|c1<<2|c2<<4|c3<<6 (codes < 4, so the shifted fields are
    disjoint)."""
    v = np.ascontiguousarray(codes).view(np.uint32)
    return ((v | (v >> 6) | (v >> 12) | (v >> 18))
            & np.uint32(0xFF)).astype(np.uint8)


_ASCII2CODE = bytes.maketrans(b"ACTGactg", bytes([0, 1, 2, 3] * 2))


def pack_ref_2bit(ref: bytes, padded: int, halo: int = 0) -> np.ndarray:
    """ASCII reference -> 2-bit packed uint8[(halo+padded)/4], zero
    padded, with `halo` zero positions prepended — the whole host
    prep in two C-level passes (translate + pack) instead of a LUT
    gather + copy + column shifts."""
    buf = (b"\x00" * halo + ref.translate(_ASCII2CODE)
           + b"\x00" * (padded - len(ref)))
    return pack_2bit_np(np.frombuffer(buf, dtype=np.uint8))


def scan_tables_2d_packed(packed: jnp.ndarray, k: int, m: int,
                          padded_len: int, length: jnp.ndarray,
                          threshold: U.U64, cols: int = 512) -> ScanTables:
    """scan_tables_2d over a 2-bit-packed codes array (see pack_2bit_np)."""
    codes = unpack_2bit(packed, padded_len)
    return scan_tables_2d(codes, k, m, padded_len, length, threshold, cols)


def _sl(a, off, width):
    return jax.lax.slice_in_dim(a, off, off + width, axis=1)


def _slh(a, off, width):
    return U.U64(_sl(a.hi, off, width), _sl(a.lo, off, width))


def _mmer_build_block(c2, m, w_m):
    """Rolling canonical m-mers + hashes for a (Rb, C+halo) code block:
    returns (canon, rev, hh) of width w_m."""
    R = c2.shape[0]
    fwd = jnp.zeros((R, w_m), jnp.uint32)
    rc = jnp.zeros((R, w_m), jnp.uint32)
    for j in range(m):
        c = _sl(c2, j, w_m)
        fwd = (fwd << 2) | c
        rc = rc | ((c ^ 2) << (2 * j))
    rev = rc < fwd
    # unsigned minimum via select
    canon = jnp.where(rev, rc, fwd)
    return canon, rev, xxh64_u32(canon)


def _mmer_elect_block(c2, k, m, C, halo):
    """Per-position m-mers, hashes and exact window elections for a
    (Rb, C+halo) block of codes — the shared core of the successor-table
    scan (legacy path) and the sync-field scan (ops/field.py).

    Returns (canon, rev, hh, em, ep, er, eh, h_ent) where election
    arrays have width C+W (window starts) and h_ent has width C+W
    (entering m-mer hashes, offset k-m+1)."""
    W = k - m + 1
    sl, slh = _sl, _slh

    w_m = C + halo - (m - 1)
    canon, rev, hh = _mmer_build_block(c2, m, w_m)

    # window elections (exact regular_minimizer_pos fold, right-to-left)
    w_e = w_m - (k - m)  # = C + W
    mini = sl(canon, k - m, w_e)
    is_rev = sl(rev, k - m, w_e)
    pos = jnp.where(is_rev, 0, k - m).astype(_I32)
    hmin = slh(hh, k - m, w_e)
    for i in range(1, W):
        off = k - m - i
        mmer = sl(canon, off, w_e)
        local_rev = sl(rev, off, w_e)
        h = slh(hh, off, w_e)
        replace = U.gt(hmin, h)
        tie = (mmer == mini) & ~replace
        same_dir = tie & (local_rev == is_rev)
        # bool selects written as logical ops
        tie_take = same_dir & ((is_rev & (pos > i))
                               | (~is_rev & (pos > (k - m - i))))
        take = replace | tie_take
        new_pos = jnp.where(replace, k - m - i,
                            jnp.where(is_rev, i, k - m - i)).astype(_I32)
        pos = jnp.where(take, new_pos, pos)
        mini = jnp.where(take, mmer, mini)
        is_rev = (take & local_rev) | (~take & is_rev)
        hmin = U.where(take, h, hmin)
    em, ep, er, eh = mini, pos, is_rev, hmin

    # entering m-mer hash per loop position (m-mer offset k-m+1); width
    # C+W so successor/adoption scans can look W columns ahead.
    h_ent = slh(hh, k - m + 1, C + W)
    return canon, rev, hh, em, ep, er, eh, h_ent


def _elect_log(canon, rev, hh, W: int, w_e: int):
    """Exact window elections in O(log W) windowed reductions instead
    of the O(W) fold.

    Derivation (provably equal to regular_minimizer_pos,
    SubSampler.cpp:81-169, and the scalar spec
    ops/event_field.election — fuzz-pinned in tests/test_scan_2d.py).
    The right-to-left fold replaces its holder only on a strictly
    smaller hash; its position-tie branch fires only for candidates
    with the holder's exact (value, strand) pair, with MIRRORED
    candidate coordinates W-1-d for rev holders (d = in-window
    offset); a strict replacement stores the ACTUAL offset d for both
    strands, and the initial (rightmost) element stores 0 when rev.
    Writing d_R for the rightmost min-hash offset (whose element
    provides the winning pair and hash) and noting every pair
    occurrence is a min-hash position (equal value => equal hash):

      * fwd winner: pos = min offset over FWD min-hash positions
        (initial W-1 = its own d; replacement d_R; ties lower to the
        leftmost pair offset);
      * rev winner with d_R == W-1: the initial element's mirrored 0
        can never be lowered (tie coordinates W-1-d > 0): pos = 0;
      * rev winner with d_R < W-1: pos = min(d_R, W-1-d_2) where d_2
        is the LARGEST pair offset below d_R — deeper occurrences
        mirror to larger coordinates and never win.

    Reduction A (lexmin by H asc, offset desc — overlap-safe) yields
    (em, er, eh) and d_R; reduction B (H asc, fwd-before-rev, offset
    asc) yields the fwd-case position; reduction D tracks, per
    (min-H, rev) class, the two largest offsets and their values over
    a DISJOINT binary decomposition of the window (second-max does not
    survive overlapping covers). True 64-bit hash collisions between
    distinct values inside one window raise `flag` (~2^-64/window) and
    the caller falls back to the exact fold path.

    Returns (em u32, ep i32, er bool, eh U64, flag bool), each of
    width w_e; requires canon width w_m >= w_e + W - 1 (the block
    layout gives exactly that)."""
    R, w_m = canon.shape
    assert w_m >= w_e + W - 1 and w_m < (1 << 20), (w_m, w_e, W)
    o = jax.lax.broadcasted_iota(_I32, (R, w_m), 1)
    pv = canon | (rev.astype(_U32) << 30)
    kb = (rev.astype(_I32) << 20) | o
    t = 1
    while t * 2 <= W:
        t *= 2

    def wreduce(h_hi, h_lo, aux, sat, tie_left, lo_off, hi_off):
        """Suffix-aligned doubling: after the loop column x reduces
        [max(0, x-t+1), x]; the final combine of the window's two
        (overlapping — the op is an idempotent lexmin) covering slices
        returns per-window winners."""
        cur = 1
        while cur < t:
            w_ = w_m - cur
            lh, ll = _sl(h_hi, 0, w_), _sl(h_lo, 0, w_)
            rh, rl = _sl(h_hi, cur, w_), _sl(h_lo, cur, w_)
            la, ra = _sl(aux, 0, w_), _sl(aux, cur, w_)
            ls, rs = _sl(sat, 0, w_), _sl(sat, cur, w_)
            left = (lh < rh) | ((lh == rh) & (
                (ll < rl) | ((ll == rl) & tie_left(la, ra))))
            h_hi = jnp.concatenate(
                [h_hi[:, :cur], jnp.where(left, lh, rh)], axis=1)
            h_lo = jnp.concatenate(
                [h_lo[:, :cur], jnp.where(left, ll, rl)], axis=1)
            aux = jnp.concatenate(
                [aux[:, :cur], jnp.where(left, la, ra)], axis=1)
            sat = jnp.concatenate(
                [sat[:, :cur], jnp.where(left, ls, rs)], axis=1)
            cur *= 2
        lh, ll = _sl(h_hi, lo_off, w_e), _sl(h_lo, lo_off, w_e)
        rh, rl = _sl(h_hi, hi_off, w_e), _sl(h_lo, hi_off, w_e)
        la, ra = _sl(aux, lo_off, w_e), _sl(aux, hi_off, w_e)
        ls, rs = _sl(sat, lo_off, w_e), _sl(sat, hi_off, w_e)
        left = (lh < rh) | ((lh == rh) & (
            (ll < rl) | ((ll == rl) & tie_left(la, ra))))
        return (jnp.where(left, lh, rh), jnp.where(left, ll, rl),
                jnp.where(left, la, ra), jnp.where(left, ls, rs))

    # window [s, s+W-1] = combine(cols [s, s+t-1], cols [s+W-t, s+W-1])
    a_hi, a_lo, a_o, a_pv = wreduce(
        hh.hi, hh.lo, o, pv, lambda l, r: l > r, t - 1, W - 1)
    _bh, _bl, b_k, b_pv = wreduce(
        hh.hi, hh.lo, kb, pv, lambda l, r: l < r, t - 1, W - 1)

    # ---- reduction D: top-2 offsets (+values) of the (min-H, rev)
    # class, over disjoint pow2 pieces. Merge of (a LEFT of b): the
    # preferred-key side wins outright; equal keys merge d-pairs —
    # disjointness gives b.d1 > a.d1, so d1 = b.d1 and d2 =
    # max(a.d1, b.d2). kr = 0 for rev (preferred after H).
    def d_merge(a, b):
        ah, al, akr, ad1, av1, ad2, av2 = a
        bh, bl, bkr, bd1, bv1, bd2, bv2 = b
        take_a = (ah < bh) | ((ah == bh) & (
            (al < bl) | ((al == bl) & (akr < bkr))))
        eq = (ah == bh) & (al == bl) & (akr == bkr)
        a1_gt = ad1 > bd2
        m_d2 = jnp.where(a1_gt, ad1, bd2)
        m_v2 = jnp.where(a1_gt, av1, bv2)
        h_hi = jnp.where(take_a, ah, bh)
        h_lo = jnp.where(take_a, al, bl)
        kr = jnp.where(take_a, akr, bkr)
        d1 = jnp.where(eq | ~take_a, bd1, ad1)
        v1 = jnp.where(eq | ~take_a, bv1, av1)
        d2 = jnp.where(eq, m_d2, jnp.where(take_a, ad2, bd2))
        v2 = jnp.where(eq, m_v2, jnp.where(take_a, av2, bv2))
        return h_hi, h_lo, kr, d1, v1, d2, v2

    def d_slice(arrs, off, width):
        return tuple(_sl(a, off, width) for a in arrs)

    lvl = (hh.hi, hh.lo, (~rev).astype(_U32), o, canon,
           jnp.full_like(o, -1), jnp.zeros_like(canon))
    levels = {}
    size = 1
    if size & W:
        levels[size] = lvl
    while size * 2 <= W:
        w_ = w_m - size
        lvl = tuple(
            jnp.concatenate([full[:, :size], merged], axis=1)
            for full, merged in zip(
                lvl, d_merge(d_slice(lvl, 0, w_),
                             d_slice(lvl, size, w_))))
        size *= 2
        if size & W:
            levels[size] = lvl
    acc = None
    base = 0
    for size in sorted(levels, reverse=True):   # leftmost piece first
        piece = d_slice(levels[size], base + size - 1, w_e)
        acc = piece if acc is None else d_merge(acc, piece)
        base += size
    _dh, _dl, _dkr, d1, v1, d2, v2 = acc

    s_col = jax.lax.broadcasted_iota(_I32, (R, w_e), 1)
    em = a_pv & ((1 << 30) - 1)
    er = (a_pv >> 30) != 0
    eh = U.U64(a_hi, a_lo)
    d_a = a_o - s_col
    d_b = (b_k & ((1 << 20) - 1)) - s_col
    rev_b = (b_k >> 20) != 0
    val_b = b_pv & ((1 << 30) - 1)
    d1r = d1 - s_col
    d2r = d2 - s_col                      # < 0 when absent
    has2 = d2 >= 0
    pos_rev = jnp.where(
        d_a == W - 1, 0,
        jnp.minimum(d_a, jnp.where(has2, (W - 1) - d2r, d_a)))
    ep = jnp.where(er, pos_rev, d_b).astype(_I32)
    flag = jnp.where(
        er,
        (v1 != em) | (d1r != d_a) | (has2 & (v2 != em)),
        (val_b != em) | rev_b)
    return em, ep, er, eh, flag


def _mmer_elect_block_log(c2, k, m, C, halo):
    """_mmer_elect_block with the O(log W) election reduction; returns
    the same tuple plus the per-window collision flag (see _elect_log).
    A raised flag routes the tile through the exact fold/walker
    fallback."""
    W = k - m + 1
    w_m = C + halo - (m - 1)
    canon, rev, hh = _mmer_build_block(c2, m, w_m)
    w_e = w_m - (k - m)
    em, ep, er, eh, flag = _elect_log(canon, rev, hh, W, w_e)
    h_ent = _slh(hh, k - m + 1, C + W)
    return canon, rev, hh, em, ep, er, eh, h_ent, flag


import os as _os

_ELECT_IMPL = _os.environ.get("SPSP_ELECT", "fold")


def elect_block_flagged(c2, k, m, C, halo):
    """Election backend for the field engine: the exact fold plus a
    constant-False collision flag.

    The O(log W) reduction (_elect_log) is bit-exact (fuzz-pinned in
    tests/test_scan_2d.py); the fold stays the default until the two
    are compared on the GPU (ROADMAP G3). SPSP_ELECT=log switches the
    engine to the reduction for that measurement."""
    if _ELECT_IMPL == "log":
        return _mmer_elect_block_log(c2, k, m, C, halo)
    canon, rev, hh, em, ep, er, eh, h_ent = _mmer_elect_block(
        c2, k, m, C, halo)
    return canon, rev, hh, em, ep, er, eh, h_ent, jnp.zeros_like(er)


def _block_tables(c2, row0, length, threshold, k, m, C, halo):
    """Successor/payload tables for a (Rb, C+halo) block of codes whose
    first row starts at flat position row0*C. Shared by the XLA 2D path
    (whole grid) and the Pallas kernel (per block)."""
    W = k - m + 1
    R = c2.shape[0]
    sl, slh = _sl, _slh

    canon, rev, hh, em, ep, er, eh, h_ent = _mmer_elect_block(
        c2, k, m, C, halo)

    pos2d = ((jax.lax.broadcasted_iota(_I32, (R, C), 0) + row0) * C
             + jax.lax.broadcasted_iota(_I32, (R, C), 1))
    last_i = (length - k - 1).astype(_I32)

    h_ent0 = slh(h_ent, 0, C)
    # rescan-node state: election of window j+1
    em_r = sl(em, 1, C)
    ep_r = sl(ep, 1, C)
    er_r = sl(er, 1, C)
    eh_r = slh(eh, 1, C)
    pa = pos2d + W
    pr = ep_r + pos2d + 1

    # fused successor scan for both node types
    na_pos = jnp.full((R, C), -1, _I32)
    na_adopt = jnp.zeros((R, C), bool)
    na_found = jnp.zeros((R, C), bool)
    nr_pos = jnp.full((R, C), -1, _I32)
    nr_adopt = jnp.zeros((R, C), bool)
    nr_found = jnp.zeros((R, C), bool)
    for w in range(1, W + 1):
        i = pos2d + w
        hi = slh(h_ent, w, C)
        ok = i <= last_i
        lt_a = U.lt(hi, h_ent0)
        adopt = (i <= pa) & lt_a & ok
        rescan = (i == pa) & ~lt_a & ok
        ev = adopt | rescan
        take = ev & ~na_found
        na_pos = jnp.where(take, i, na_pos)
        na_adopt = (take & adopt) | (~take & na_adopt)
        na_found = na_found | ev
        lt_r = U.lt(hi, eh_r)
        adopt = (i <= pr) & lt_r & ok
        rescan = (i == pr) & ~lt_r & ok
        ev = adopt | rescan
        take = ev & ~nr_found
        nr_pos = jnp.where(take, i, nr_pos)
        nr_adopt = (take & adopt) | (~take & nr_adopt)
        nr_found = nr_found | ev

    c_ent = sl(canon, k - m + 1, C)
    r_ent = sl(rev, k - m + 1, C)
    sel_a = U.le(h_ent0, threshold)
    sel_r = U.le(eh_r, threshold)

    return (na_pos, na_adopt, nr_pos, nr_adopt, c_ent, r_ent, sel_a,
            em_r, er_r, sel_r, em, ep, er, eh, h_ent0)


def walk_chain_host(t: ScanTables):
    """Follow successor links from the initial state.

    Uses the native C walker when available (microseconds for millions
    of events); falls back to a Python loop. Returns (event_positions
    int64[], event_types uint8[] (0=A,1=R), values uint32[], revs
    bool[], sels bool[]) plus the initial payload (val, rev, sel).
    """
    from supersampler_tpu.native import walk_chain_native

    npa = np.ascontiguousarray(np.asarray(t.nxt_pos_a, dtype=np.int32))
    naa = np.ascontiguousarray(
        np.asarray(t.nxt_adopt_a).astype(np.uint8))
    npr = np.ascontiguousarray(np.asarray(t.nxt_pos_r, dtype=np.int32))
    nar = np.ascontiguousarray(
        np.asarray(t.nxt_adopt_r).astype(np.uint8))
    init_pos = int(t.init_nxt_pos)
    init_adopt = bool(t.init_nxt_adopt)

    res = walk_chain_native(npa, naa, npr, nar, init_pos, init_adopt)
    if res is not None:
        pos32, typ = res
        pos = pos32.astype(np.int64)
    else:
        pos_list, type_list = [], []
        p, ty = init_pos, 0 if init_adopt else 1
        while p >= 0:
            pos_list.append(p)
            type_list.append(ty)
            if ty == 0:
                p, ty = int(npa[p]), 0 if naa[p] else 1
            else:
                p, ty = int(npr[p]), 0 if nar[p] else 1
        pos = np.array(pos_list, dtype=np.int64)
        typ = np.array(type_list, dtype=np.uint8)

    is_a = typ == 0
    val = np.where(is_a, np.asarray(t.val_a)[pos], np.asarray(t.val_r)[pos])
    rev = np.where(is_a, np.asarray(t.rev_a)[pos], np.asarray(t.rev_r)[pos])
    sel = np.where(is_a, np.asarray(t.sel_a)[pos], np.asarray(t.sel_r)[pos])
    init = (int(t.init_val), bool(t.init_rev), bool(t.init_sel))
    return pos, typ, val.astype(np.uint32), rev.astype(bool), sel.astype(
        bool), init
