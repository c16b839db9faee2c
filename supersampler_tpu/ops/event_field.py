"""Sync-segment decomposition of the minimizer-scan state machine.

The reference's streaming loop (SubSampler.cpp:367-440) is a serial
state machine; the successor-table engine parallelizes the
per-position math but still extracts the event chain as a walk
(ops/walker.py). This module removes the serial chain entirely, using
an exact synchronization theorem:

  THEOREM (safe sync). The machine state after any event at step i
  always holds a minimizer hash h = H[q] for some m-mer position
  q in (i - W, i + W], because adoptions install the entering position
  i + W and rescans re-elect a window [i+1, i+W] (positions whose
  hashes are real H values at most W old — even through the
  reference's mirrored-position quirk for reverse-strand minimizers,
  which can keep a STALE minimizer past its true window exit but never
  refreshes h from anything but a real election). Therefore if
    H[v] < min{ H[q] : q in [max(0, v-2W), v-1] }   (strict)
  then at step i = v - W the adoption branch fires NO MATTER the
  history, and the full state becomes locally known:
    (minimizer = canon[v], hash = H[v], position_min = v,
     is_rev = rev[v]), with a boundary event at step v - W.

Every such v is a cut: the chain between consecutive cuts is resolved
independently (and exactly — the resolution below replays the
reference's update rules verbatim, ties, mirrored positions and all),
so segments can run in parallel lanes instead of one serial walk.

This file is the NumPy reference implementation (the correctness spec
fuzz-tested against the scalar oracle); the device version is
ops/field.py.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

U64 = np.uint64
_PRIME1 = U64(11400714785074694791)
_PRIME2 = U64(14029467366897019727)
_PRIME3 = U64(1609587929392839161)
_PRIME4 = U64(9650029242287828579)
_PRIME5 = U64(2870177450012600261)
_SEED = U64(1312)


def xxh64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized XXHash64 of each uint64 (8 LE bytes), seed 1312 —
    the reference's unrevhash (utils.cpp:244-249, xxhash64.h:158)."""
    old = np.seterr(over="ignore")
    try:
        h = _SEED + _PRIME5 + U64(8)
        v = x.astype(U64) * _PRIME2
        v = ((v << U64(31)) | (v >> U64(33))) * _PRIME1
        h = h ^ v
        h = ((h << U64(27)) | (h >> U64(37))) * _PRIME1 + _PRIME4
        h = (h ^ (h >> U64(33))) * _PRIME2
        h = (h ^ (h >> U64(29))) * _PRIME3
        h = h ^ (h >> U64(32))
        return h
    finally:
        np.seterr(**old)


class Precomp(NamedTuple):
    """Per-m-mer-position arrays for one sequence."""

    canon: np.ndarray   # uint64 canonical m-mer values
    rev: np.ndarray     # bool, canonical == reverse strand
    H: np.ndarray       # uint64 hashes
    W: int


def precompute(codes: np.ndarray, k: int, m: int) -> Precomp:
    n_m = codes.size - m + 1
    fwd = np.zeros(n_m, U64)
    rc = np.zeros(n_m, U64)
    for j in range(m):
        c = codes[j : j + n_m].astype(U64)
        fwd = (fwd << U64(2)) | c
        rc = rc | ((c ^ U64(2)) << U64(2 * j))
    rev = rc < fwd
    canon = np.where(rev, rc, fwd)
    return Precomp(canon, rev, xxh64_np(canon), k - m + 1)


def election(pc: Precomp, start: int):
    """regular_minimizer_pos (SubSampler.cpp:81-169) over the window of
    m-mers [start, start + W), from precomputed arrays; returns
    (value, IN-WINDOW position with the reference's strand-mirrored
    arithmetic, rev, hash)."""
    W = pc.W
    o = start + W - 1               # fold scans right-to-left
    mini, is_rev, h = pc.canon[o], bool(pc.rev[o]), pc.H[o]
    position = 0 if is_rev else W - 1
    for i in range(1, W):
        o = start + W - 1 - i
        mmer, local_rev, hh = pc.canon[o], bool(pc.rev[o]), pc.H[o]
        if h > hh:
            position, mini, is_rev, h = W - 1 - i, mmer, local_rev, hh
        elif mmer == mini and local_rev == is_rev:
            if is_rev and position > i:
                position, mini, is_rev, h = i, mmer, local_rev, hh
            if (not is_rev) and position > W - 1 - i:
                position, mini, is_rev, h = W - 1 - i, mmer, local_rev, hh
    return mini, position, is_rev, h


class Event(NamedTuple):
    i: int          # loop step of the boundary
    val: int        # NEW minimizer value installed by the event
    rev: bool
    p: int          # absolute position_min after the event
    h: int          # hash after the event
    adopt: bool


def sync_points(pc: Precomp, length: int, k: int) -> np.ndarray:
    """Positions v (m-mer coords) with H[v] strictly below every H in
    [max(0, v-2W), v-1] — each yields a guaranteed adoption event at
    step v - W. Only steps in [1, L-k-1] matter (step 0's state comes
    from the initial election; the loop ends at L-k-1)."""
    W = pc.W
    L = length
    H = pc.H
    out = []
    for v in range(W + 1, min(H.size, (L - k - 1) + W + 1)):
        a = max(0, v - 2 * W)
        if a < v and np.all(H[v] < H[a:v]):
            out.append(v)
    return np.asarray(out, np.int64)


def resolve(pc: Precomp, length: int, k: int,
            threshold: int) -> Tuple[List[Event], Tuple]:
    """Exact event chain via sync-segment decomposition.

    Segments between sync entries are replayed with the reference's
    update rules; entry states come from the sync theorem (or the
    initial election for segment 0). Returns (events, final_state).
    Events carry the NEW state; boundary emits derive from the
    previous event's payload exactly as in ops/walker.py.
    """
    W = pc.W
    L = length
    n_loop = L - k                  # steps 0..n_loop-1
    syncs = sync_points(pc, L, k)
    # segment entry steps: step 0 with init election, then v - W for
    # each sync v (dedup/clip)
    entries = [0] + [int(v) - W for v in syncs if 0 < v - W < n_loop]

    # initial state: election of window 0 (m-mers [0, W))
    mini, pos_in, is_rev, h = election(pc, 0)
    state = (int(mini), pos_in + 0, is_rev, int(h))  # p absolute = pos_in

    events: List[Event] = []
    eidx = 0
    for si, e in enumerate(entries):
        end = entries[si + 1] if si + 1 < len(entries) else n_loop
        if si > 0:
            # sync entry: adoption at step e of the entering m-mer v=e+W
            v = e + W
            state = (int(pc.canon[v]), v, bool(pc.rev[v]), int(pc.H[v]))
            events.append(Event(e, state[0], state[2], state[1],
                                state[3], True))
            start = e + 1
        else:
            start = 0
        val, p, rv, h = state
        for i in range(start, end):
            q = i + W
            new_h = int(pc.H[q])
            if new_h < h:
                val, h, p, rv = int(pc.canon[q]), new_h, q, bool(pc.rev[q])
                events.append(Event(i, val, rv, p, h, True))
            elif i >= p:
                mini, pos_in, is_rev, hh = election(pc, i + 1)
                val, p, rv, h = int(mini), pos_in + i + 1, bool(is_rev), \
                    int(hh)
                events.append(Event(i, val, rv, p, h, False))
        state = (val, p, rv, h)
    return events, state
