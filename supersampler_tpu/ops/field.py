"""Sync-field scan: gather-free, walker-free event extraction.

Replaces the successor-table + serial-walker pipeline (ops/minimizer.py
+ ops/walker.py) for the hot path. Uses the sync theorem proven in
ops/event_field.py: a position whose entering hash is strictly below
every hash in the preceding 2W positions forces an adoption regardless
of history, so the streaming machine's state there is locally known.

The sequence is split into fixed blocks of B loop positions. Each block
containing a sync resolves its suffix [first_sync, B) independently
(sweep 1), which also yields every block's EXIT state without knowing
its prefix; prefixes [0, first_sync) then resolve from the
predecessor's exit (sweep 2, iterated a bounded number of times for
runs of syncless blocks — vanishingly rare at B=256). All sweeps are
dense (n_blocks,)-lane vector ops inside a fori loop over columns: no
gathers, no scalar-core serialization. Blocks that remain unresolved
after the pass budget (pathological content, e.g. megabase
homopolymers) raise a status flag and the caller falls back to the
exact legacy walker path.

Emit/compact semantics replicate the reference boundary loop
(SubSampler.cpp:401-454) exactly as ops/walker.py does; outputs use the
same 9-tuple compact contract.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from supersampler_tpu.backend import engine
from supersampler_tpu.ops.minimizer import elect_block_flagged, _sl, \
    _slh, unpack_2bit

_I32 = jnp.int32
_U32 = jnp.uint32
_FF = jnp.uint32(0xFFFFFFFF)
_B = 256                 # resolution block size (loop positions)
_MAX_PASSES = 4          # sweep-2 iterations (syncless-run budget)
_UNROLL = 8              # columns per lax.scan step of the XLA sweep


class FieldTables(NamedTuple):
    """Flat per-loop-position arrays, padded to a multiple of _B."""

    h_hi: jnp.ndarray    # entering m-mer hash at j (u32 x2)
    h_lo: jnp.ndarray
    cv: jnp.ndarray      # entering canon value | rev<<30
    em: jnp.ndarray      # election of window j+1: value | rev<<30
    ep: jnp.ndarray      # election in-window position (i32)
    eh_hi: jnp.ndarray   # election hash
    eh_lo: jnp.ndarray
    sync: jnp.ndarray    # bool: guaranteed adoption at j
    last_i: jnp.ndarray  # i32 scalar: final valid loop position
    init_val: jnp.ndarray   # u32 value | rev<<30 (window-0 election)
    init_p: jnp.ndarray     # i32 absolute position_min
    init_h_hi: jnp.ndarray
    init_h_lo: jnp.ndarray
    eflag: jnp.ndarray   # bool scalar: a consumed election hit a hash
                         # collision (log-election undefined -> the
                         # caller must take the exact fold fallback)


def _pow2_le(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _field_core(codes: jnp.ndarray, k: int, m: int, P: int, C: int,
                first_row):
    """Shared field-scan core on the (R, C) 2D layout: per-position
    entering hashes/values, window elections, and RAW sync flags
    (strict minimum vs the previous 2W entering hashes; position-bound
    masking is the caller's job).

    first_row: (R,) bool — rows with no predecessor row (their sync
    lookback pads +inf). One True for a single sequence; one per
    record for the batched layout.

    Returns (h0, cv, em_r, ep_r, eh_r, sync_raw, em, ep, er, eh,
    eflag) where eflag (R, C+1) flags windows whose O(log W) election
    hit a hash collision (window start w = r*C + c; see
    _mmer_elect_block_log — flagged tiles take the exact fold/walker
    fallback)."""
    W = k - m + 1
    halo = k + W
    assert C > halo and P % C == 0 and P % _B == 0
    R = P // C

    base = codes.reshape(R, C)
    c2 = jnp.concatenate(
        [base, jnp.roll(base, -1, axis=0)[:, :halo]],
        axis=1).astype(jnp.uint32)
    canon, rev, hh, em, ep, er, eh, h_ent, eflag = \
        elect_block_flagged(c2, k, m, C, halo)

    h0 = _slh(h_ent, 0, C)                       # entering hash per j
    c_ent = _sl(canon, k - m + 1, C)
    r_ent = _sl(rev, k - m + 1, C)
    cv = c_ent | (r_ent.astype(_U32) << 30)
    em_r = _sl(em, 1, C) | (_sl(er, 1, C).astype(_U32) << 30)
    ep_r = _sl(ep, 1, C)
    eh_r = _slh(eh, 1, C)
    sync = _sync_from_h0(h0, first_row, W, C)
    # elections are consumed for window starts [0, C] per row (em_r
    # slices [1, C+1); window 0 feeds the init election)
    return (h0, cv, em_r, ep_r, eh_r, sync, em, ep, er, eh,
            _sl(eflag, 0, C + 1))


def _sync_from_h0(h0, first_row, W: int, C: int):
    """Sync flags: strict minimum vs the previous 2W entering hashes,
    via log-step windowed mins on a left-halo'd layout (the previous
    row's tail supplies the lookback; predecessor-less rows pad
    +inf)."""
    R = h0.hi.shape[0]
    LH = 2 * W
    prev_tail_hi = jnp.roll(h0.hi, 1, axis=0)[:, C - LH:]
    prev_tail_lo = jnp.roll(h0.lo, 1, axis=0)[:, C - LH:]
    ff = jnp.broadcast_to(first_row[:, None], (R, LH))
    lh_hi = jnp.where(ff, _FF, prev_tail_hi)
    lh_lo = jnp.where(ff, _FF, prev_tail_lo)
    a_hi = jnp.concatenate([lh_hi, h0.hi], axis=1)
    a_lo = jnp.concatenate([lh_lo, h0.lo], axis=1)

    # build M_t over the halo'd array: M_t[x] = min a[x-t+1 .. x]
    t = _pow2_le(LH)
    m_hi, m_lo = a_hi, a_lo
    step = 1
    while step < t:
        w_ = a_hi.shape[1] - step
        b_hi = _sl(m_hi, 0, w_)
        b_lo = _sl(m_lo, 0, w_)
        c_hi = _sl(m_hi, step, w_)
        c_lo = _sl(m_lo, step, w_)
        lt = (b_hi < c_hi) | ((b_hi == c_hi) & (b_lo < c_lo))
        m_hi = jnp.concatenate(
            [m_hi[:, :step], jnp.where(lt, b_hi, c_hi)], axis=1)
        m_lo = jnp.concatenate(
            [m_lo[:, :step], jnp.where(lt, b_lo, c_lo)], axis=1)
        step *= 2
    # min over [c-2W, c-1] = min(M_t[c-1], M_t[c-(2W-t)-1]); in the
    # halo'd frame position j sits at column j_loc + 2W
    off1 = LH - 1
    off2 = LH - (LH - t) - 1      # = t - 1
    w1_hi, w1_lo = _sl(m_hi, off1, C), _sl(m_lo, off1, C)
    w2_hi, w2_lo = _sl(m_hi, off2, C), _sl(m_lo, off2, C)
    lt12 = (w2_hi < w1_hi) | ((w2_hi == w1_hi) & (w2_lo < w1_lo))
    mn_hi = jnp.where(lt12, w2_hi, w1_hi)
    mn_lo = jnp.where(lt12, w2_lo, w1_lo)
    return (h0.hi < mn_hi) | ((h0.hi == mn_hi) & (h0.lo < mn_lo))


def scan_field_2d(codes: jnp.ndarray, k: int, m: int, padded_len: int,
                  length: jnp.ndarray, first_tile: bool = True,
                  cols: int = 512) -> FieldTables:
    """Dense field scan (no successor tables): m-mers, hashes, window
    elections and sync flags in the 2D-tiled layout of
    scan_tables_2d."""
    P = padded_len
    C = cols
    W = k - m + 1
    R = P // C
    first_row = jnp.arange(R) == 0
    h0, cv, em_r, ep_r, eh_r, sync, em, ep, er, eh, efl = _field_core(
        codes, k, m, P, C, first_row)

    last_i = (length - k - 1).astype(_I32)
    j2d = (jax.lax.broadcasted_iota(_I32, (R, C), 0) * C
           + jax.lax.broadcasted_iota(_I32, (R, C), 1))
    # the first 2W positions' lookback would need hashes this layout
    # doesn't carry (window-0 m-mers for the first tile, the previous
    # tile's entering hashes otherwise): never flag them — the entry
    # state resolves that prefix exactly anyway
    sync = sync & (j2d <= last_i) & (j2d >= 2 * W)

    # collision flag: only windows whose elections are consumed matter
    # (window start w <= last_i + 1; w = 0 feeds the init election)
    w2d = (jax.lax.broadcasted_iota(_I32, (R, C + 1), 0) * C
           + jax.lax.broadcasted_iota(_I32, (R, C + 1), 1))
    eflag = jnp.any(efl & (w2d <= last_i + 1))

    flat = lambda a: a.reshape(-1)
    init_val = (em[0, 0] | (er[0, 0].astype(_U32) << 30))
    return FieldTables(
        h_hi=flat(h0.hi), h_lo=flat(h0.lo), cv=flat(cv), em=flat(em_r),
        ep=flat(ep_r), eh_hi=flat(eh_r.hi), eh_lo=flat(eh_r.lo),
        sync=flat(sync), last_i=last_i,
        init_val=init_val, init_p=ep[0, 0],
        init_h_hi=eh.hi[0, 0], init_h_lo=eh.lo[0, 0], eflag=eflag)


def scan_field_2d_packed(packed, k, m, padded_len, length,
                         first_tile: bool = True, cols: int = 512):
    codes = unpack_2bit(packed, padded_len)
    return scan_field_2d(codes, k, m, padded_len, length, first_tile,
                         cols)


class BatchedFieldTables(NamedTuple):
    """Field tables for a BATCH of independent records laid
    position-contiguously: record b owns flat positions
    [b*P_rec, (b+1)*P_rec). Per-record scalars become (B,) arrays."""

    h_hi: jnp.ndarray    # (B*P_rec,) flat per-position arrays
    h_lo: jnp.ndarray
    cv: jnp.ndarray
    em: jnp.ndarray
    ep: jnp.ndarray
    eh_hi: jnp.ndarray
    eh_lo: jnp.ndarray
    sync: jnp.ndarray
    last_i: jnp.ndarray      # (B,) i32 final valid LOCAL loop position
    init_val: jnp.ndarray    # (B,) u32 window-0 election value|rev<<30
    init_p: jnp.ndarray      # (B,) i32
    init_h_hi: jnp.ndarray   # (B,) u32
    init_h_lo: jnp.ndarray
    eflag: jnp.ndarray       # (B,) bool per-record collision flag


def scan_field_batched(packed, k: int, m: int, P_rec: int, lengths,
                       cols: int = 512) -> BatchedFieldTables:
    """Field scan of B records in ONE program: packed (B, P_rec//4)
    2-bit slabs, lengths (B,) i32 cleaned lengths (< k => record is
    inert). P_rec must be a multiple of cols and _B. The records share
    the (R, C) layout back-to-back; each record's rows are
    self-contained (its first row's sync lookback pads +inf, and
    positions past its last_i are masked by the per-lane bounds in
    resolve_field_batched).

    Replicates the reference's per-sequence scan loop semantics
    (SubSampler.cpp:306-510) for every record independently — the
    many-short-record analog of scan_field_2d."""
    B_n = packed.shape[0]
    C = cols
    W = k - m + 1
    P = B_n * P_rec
    R = P // C
    rpr = P_rec // C              # rows per record
    codes = unpack_2bit(packed.reshape(-1), P)
    row_idx = jnp.arange(R)
    first_row = (row_idx % rpr) == 0
    h0, cv, em_r, ep_r, eh_r, sync, em, ep, er, eh, efl = _field_core(
        codes, k, m, P, C, first_row)

    last_i = (lengths - k - 1).astype(_I32)          # (B,)
    jloc = ((row_idx % rpr)[:, None] * C
            + jax.lax.broadcasted_iota(_I32, (R, C), 1))
    li_row = last_i[row_idx // rpr]
    sync = sync & (jloc <= li_row[:, None]) & (jloc >= 2 * W)

    # per-record collision flag over consumed windows (local start
    # wloc <= last_i[b] + 1)
    wloc = ((row_idx % rpr)[:, None] * C
            + jax.lax.broadcasted_iota(_I32, (R, C + 1), 1))
    efl_m = efl & (wloc <= li_row[:, None] + 1)
    eflag = jnp.any(efl_m.reshape(B_n, rpr * (C + 1)), axis=1)

    flat = lambda a: a.reshape(-1)
    r0 = jnp.arange(B_n) * rpr
    init_val = em[r0, 0] | (er[r0, 0].astype(_U32) << 30)
    return BatchedFieldTables(
        h_hi=flat(h0.hi), h_lo=flat(h0.lo), cv=flat(cv), em=flat(em_r),
        ep=flat(ep_r), eh_hi=flat(eh_r.hi), eh_lo=flat(eh_r.lo),
        sync=flat(sync), last_i=last_i, init_val=init_val,
        init_p=ep[r0, 0], init_h_hi=eh.hi[r0, 0],
        init_h_lo=eh.lo[r0, 0], eflag=eflag)


class FieldState(NamedTuple):
    """Per-lane machine state (the reference loop's registers plus the
    previous-event bookkeeping the emits need)."""

    val: jnp.ndarray     # u32: value | rev<<30 | sel<<31 of held minimizer
    h_hi: jnp.ndarray
    h_lo: jnp.ndarray
    p: jnp.ndarray       # i32 absolute position_min
    last_ev: jnp.ndarray  # i32 absolute position of the last event (-1)
    n_ev: jnp.ndarray    # i32 events so far in this lane's resolved part


def _transpose_tables(t: FieldTables, n_blk: int):
    """Column-major (B, n_blk) views of the per-position arrays: the
    XLA sweep's lax.scan consumes one column per step with no in-loop
    slicing, and the GPU sweep reads column r of a lane block as
    contiguous words (coalesced loads)."""
    tr = lambda a: a.reshape(n_blk, _B).T
    return (tr(t.h_hi), tr(t.h_lo), tr(t.cv), tr(t.em), tr(t.ep),
            tr(t.eh_hi), tr(t.eh_lo))


def _sweep(tT, j0, lastiv, W: int, n_blk: int, state0: FieldState,
           start, end, active_lane, force_entry: bool, thr_hi, thr_lo):
    """Run the machine over columns [start, end) of every active lane.

    tT: transposed tables from _transpose_tables. start/end: (n_blk,)
    i32 column bounds per lane. j0/lastiv: (n_blk,) i32 — each lane's
    absolute position base and final valid position (per-lane so a
    BATCH of independent records can share one sweep: every lane
    carries its own record's coordinate frame). When force_entry, an
    adoption is forced at column == start (the sync theorem's entry;
    its emit bookkeeping is deferred — the returned is_ent mask marks
    it).

    Returns (exit_state, ev(B, n_blk), prev_val(B, n_blk),
    prev_last(B, n_blk), is_ent(B, n_blk)): per-event flag + the
    PREVIOUS event's payload (val|rev<<30|sel<<31) and last_position —
    what boundary emits need — plus the explicit entry-event mask
    (cross-tile carries make last_ev arbitrarily negative, so no
    in-band plast sentinel can mark entries safely). Outputs are
    lax.scan-stacked; the caller merges sweeps (each position fires in
    exactly one ACTIVE sweep).
    """
    h_hiT, h_loT, cvT, emT, epT, eh_hiT, eh_loT = tT
    rs = jnp.arange(_B, dtype=_I32)

    def step(st, xs):
        r, nh_hi, nh_lo, cv_c, em_c, ep_c, ehh_c, ehl_c = xs
        j = j0 + r
        act = active_lane & (r >= start) & (r < end) & (j <= lastiv)
        is_entry = act & (r == start) if force_entry else \
            jnp.zeros_like(act)
        lt = (nh_hi < st.h_hi) | ((nh_hi == st.h_hi)
                                  & (nh_lo < st.h_lo))
        adopt = (act & lt) | is_entry
        expiry = act & ~adopt & (j >= st.p)
        ev = adopt | expiry

        new_hh = jnp.where(adopt, nh_hi, ehh_c)
        new_hl = jnp.where(adopt, nh_lo, ehl_c)
        sel = ((new_hh < thr_hi)
               | ((new_hh == thr_hi) & (new_hl <= thr_lo)))
        new_val = (jnp.where(adopt, cv_c, em_c)
                   | (sel.astype(_U32) << 31))
        new_p = jnp.where(adopt, j + W, ep_c + j + 1)

        prev_val = st.val
        prev_last = st.last_ev + 1
        st = FieldState(
            val=jnp.where(ev, new_val, st.val),
            h_hi=jnp.where(ev, new_hh, st.h_hi),
            h_lo=jnp.where(ev, new_hl, st.h_lo),
            p=jnp.where(ev, new_p, st.p),
            last_ev=jnp.where(ev, j, st.last_ev),
            n_ev=st.n_ev + ev.astype(_I32))
        return st, (ev, jnp.where(ev, prev_val, 0),
                    jnp.where(ev, prev_last, -1), is_entry)

    st, (ev, pval, plast, isent) = jax.lax.scan(
        step, state0, (rs, h_hiT, h_loT, cvT, emT, epT, eh_hiT, eh_loT),
        unroll=_UNROLL)
    return st, ev, pval, plast, isent


def _pow2_ge(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _rank_to_lane(offs, counts, sel_cap: int, n_blk: int):
    """lane index owning each output rank in [0, sel_cap) — the
    inverse of the per-lane count prefix sum.

    Equivalent to jnp.searchsorted(offs, arange(sel_cap), 'right') for
    ranks < offs[-1], but loop-free (searchsorted lowers to an XLA
    while loop). Scatter each non-empty lane's id at its start rank,
    then a running max fills the gaps (non-empty lanes have strictly
    increasing starts, so the scatter is collision-free). Ranks >= the
    total event count return the last non-empty lane — callers mask
    those ranks out, exactly as they clipped searchsorted's n_blk
    result."""
    starts = offs - counts
    lanes = jnp.arange(n_blk, dtype=_I32)
    tgt = jnp.where(counts > 0, starts, sel_cap)
    seed = jnp.zeros((sel_cap,), _I32).at[tgt].max(lanes, mode="drop")
    return jax.lax.cummax(seed)


def _lists_from_dense(ev, pval, plast, isent, j0, n_blk: int,
                      capl: int):
    """Per-lane compacted selected-event lists from dense (B, n_blk)
    sweep outputs — the XLA path and the plain reference for the GPU
    sweep kernel, which appends to the lists directly. Entry events
    (the isent mask) are excluded; resolve_field synthesizes them once
    the prefix payload is known.

    Returns (cnt(n_blk,), pos(capl, n_blk), pval(capl, n_blk),
    plast(capl, n_blk)); cnt is exact even when a lane overflows capl
    (extra events are dropped from the lists; callers detect cnt >
    capl and flag status).
    """
    emit = ev & ((pval >> 31) == 1) & ~isent
    cnt = jnp.sum(emit, axis=0).astype(_I32)
    slot = jnp.cumsum(emit.astype(_I32), axis=0) - 1
    rows = jax.lax.broadcasted_iota(_I32, (_B, n_blk), 0)
    lanes = jax.lax.broadcasted_iota(_I32, (_B, n_blk), 1)
    j = j0[None, :] + rows
    slot_c = jnp.where(emit, slot, capl)      # capl rows are dropped
    lp = jnp.zeros((capl, n_blk), _I32).at[slot_c, lanes].set(
        jnp.where(emit, j, 0), mode="drop")
    lv = jnp.zeros((capl, n_blk), _U32).at[slot_c, lanes].set(
        jnp.where(emit, pval, 0), mode="drop")
    ll = jnp.zeros((capl, n_blk), _I32).at[slot_c, lanes].set(
        jnp.where(emit, plast, 0), mode="drop")
    return cnt, lp, lv, ll


# ----------------------------------------------------------------------
# GPU sweep kernel (Pallas through Triton). One program owns _SWEEP_LB
# consecutive lanes and runs the column loop itself, the machine state
# held in registers; column r of the block is one coalesced row of
# each transposed table. The loop runs only over the block's live
# column range (min start .. max end, clipped at the last valid
# position), so a prefix pass touches columns [0, first sync) and an
# empty pass costs one launch. Selected emits are appended straight
# into the (capl, n_blk) lists with a masked store at row cnt: no dense
# per-position event arrays are written.
# ----------------------------------------------------------------------

_SWEEP_LB = 128          # lanes per program (power of two)
_SWEEP_WARPS = 4         # one lane per thread


def _sweep_kernel(ctl_ref, st0_ref, hh_ref, hl_ref, cv_ref, em_ref,
                  ep_ref, ehh_ref, ehl_ref, xs_ref, lp_ref, lv_ref,
                  ll_ref, *, W, LB, capl, force_entry):
    """One block of LB lanes over its live columns.

    ctl rows (i32): start, end, active, j0, lastiv, thr_hi, thr_lo.
    st0 / xs rows (u32): val, h_hi, h_lo, p, last_ev, n_ev, cnt."""
    bc = jax.lax.bitcast_convert_type
    start = ctl_ref[0, :]
    end = ctl_ref[1, :]
    active = ctl_ref[2, :] != 0
    j0 = ctl_ref[3, :]
    lastiv = ctl_ref[4, :]
    thr_hi = bc(ctl_ref[5, :], _U32)
    thr_lo = bc(ctl_ref[6, :], _U32)
    lane = jax.lax.broadcasted_iota(_I32, (LB,), 0)

    zero_i = jnp.zeros((LB,), _I32)
    zero_u = jnp.zeros((LB,), _U32)

    def clear(c, carry):
        lp_ref[c, :] = zero_i
        lv_ref[c, :] = zero_u
        ll_ref[c, :] = zero_i
        return carry

    jax.lax.fori_loop(0, capl, clear, 0)

    # live column range of the block: columns r with start <= r < end
    # and j0 + r <= lastiv on some active lane
    hi_l = jnp.minimum(end, lastiv - j0 + 1)
    lo = jnp.min(jnp.where(active, start, _B))
    hi = jnp.max(jnp.where(active, hi_l, 0))

    def col(r, s):
        val, h_hi, h_lo, p, last_ev, n_ev, cnt = s
        j = j0 + r
        act = active & (r >= start) & (r < end) & (j <= lastiv)
        tab = lambda ref, dt: plgpu.load(ref.at[r, :], mask=act,
                                         other=jnp.zeros((LB,), dt))
        nh_hi = tab(hh_ref, _U32)
        nh_lo = tab(hl_ref, _U32)
        lt = (nh_hi < h_hi) | ((nh_hi == h_hi) & (nh_lo < h_lo))
        adopt = act & lt
        emit_ok = jnp.ones((LB,), jnp.bool_)
        if force_entry:
            is_entry = act & (r == start)
            adopt = adopt | is_entry
            emit_ok = ~is_entry
        expiry = act & (~adopt) & (j >= p)
        ev = adopt | expiry

        new_hh = jnp.where(adopt, nh_hi, tab(ehh_ref, _U32))
        new_hl = jnp.where(adopt, nh_lo, tab(ehl_ref, _U32))
        sel = ((new_hh < thr_hi)
               | ((new_hh == thr_hi) & (new_hl <= thr_lo)))
        new_val = (jnp.where(adopt, tab(cv_ref, _U32), tab(em_ref, _U32))
                   | (sel.astype(_U32) << 31))
        new_p = jnp.where(adopt, j + W, tab(ep_ref, _I32) + j + 1)

        # the event at j closes the super-k-mer held in the PRE-update
        # state; entry events (unknown prefix payload) are synthesized
        # by the caller
        emit = ev & ((val >> 31) == 1) & emit_ok
        slot = jnp.minimum(cnt, capl - 1)
        ok = emit & (cnt < capl)
        plgpu.store(lp_ref.at[slot, lane], j, mask=ok)
        plgpu.store(lv_ref.at[slot, lane], val, mask=ok)
        plgpu.store(ll_ref.at[slot, lane], last_ev + 1, mask=ok)
        cnt = cnt + emit.astype(_I32)

        return (jnp.where(ev, new_val, val),
                jnp.where(ev, new_hh, h_hi),
                jnp.where(ev, new_hl, h_lo),
                jnp.where(ev, new_p, p),
                jnp.where(ev, j, last_ev),
                n_ev + ev.astype(_I32), cnt)

    s0 = (st0_ref[0, :], st0_ref[1, :], st0_ref[2, :],
          bc(st0_ref[3, :], _I32), bc(st0_ref[4, :], _I32),
          bc(st0_ref[5, :], _I32), zero_i)
    val, h_hi, h_lo, p, last_ev, n_ev, cnt = jax.lax.fori_loop(
        lo, hi, col, s0)
    xs_ref[0, :] = val
    xs_ref[1, :] = h_hi
    xs_ref[2, :] = h_lo
    xs_ref[3, :] = bc(p, _U32)
    xs_ref[4, :] = bc(last_ev, _U32)
    xs_ref[5, :] = bc(n_ev, _U32)
    xs_ref[6, :] = bc(cnt, _U32)
    xs_ref[7, :] = zero_u


def _sweep_triton(tT, j0, lastiv, W: int, n_blk: int,
                  state0: FieldState, start, end, active_lane,
                  force_entry: bool, thr_hi, thr_lo, capl: int = 16,
                  interpret: bool = False):
    """GPU sweep with the contract of _sweep + _lists_from_dense:
    returns (exit_state, cnt(n_blk,), pos(capl, n_blk),
    pval(capl, n_blk), plast(capl, n_blk)). j0/lastiv: per-lane
    position base and bound (see _sweep). capl must be a power of two.

    Lanes pad up to the block size with inactive lanes (they sit after
    the real ones and are sliced off). `interpret` runs the kernel in
    the Pallas interpreter (CPU tests); no path sets it by itself."""
    LB = _SWEEP_LB
    nb = _lane_count(n_blk)

    bc = jax.lax.bitcast_convert_type
    i32 = lambda a: jnp.broadcast_to(jnp.asarray(a, _I32), (n_blk,))
    u2i = lambda a: bc(jnp.broadcast_to(jnp.asarray(a, _U32), (n_blk,)),
                       _I32)
    ctl = _pad_lanes(jnp.stack([
        i32(start), i32(end), i32(active_lane), i32(j0), i32(lastiv),
        u2i(thr_hi), u2i(thr_lo), jnp.zeros((n_blk,), _I32)]), nb)
    st0 = _pad_lanes(jnp.stack([
        state0.val, state0.h_hi, state0.h_lo, bc(state0.p, _U32),
        bc(state0.last_ev, _U32), bc(state0.n_ev, _U32),
        jnp.zeros((n_blk,), _U32), jnp.zeros((n_blk,), _U32)]), nb)
    tabs = tuple(_pad_lanes(a, nb) for a in tT)

    rows = lambda n: pl.BlockSpec((n, LB), lambda i: (0, i))
    kern = functools.partial(_sweep_kernel, W=W, LB=LB, capl=capl,
                             force_entry=force_entry)
    xs, lp, lv, ll = pl.pallas_call(
        kern,
        grid=(nb // LB,),
        in_specs=[rows(8), rows(8)] + [rows(_B)] * 7,
        out_specs=(rows(8), rows(capl), rows(capl), rows(capl)),
        out_shape=(
            jax.ShapeDtypeStruct((8, nb), _U32),
            jax.ShapeDtypeStruct((capl, nb), _I32),
            jax.ShapeDtypeStruct((capl, nb), _U32),
            jax.ShapeDtypeStruct((capl, nb), _I32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_SWEEP_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="field_sweep",
    )(ctl, st0, *tabs)

    xs = xs[:, :n_blk]
    stf = FieldState(
        val=xs[0], h_hi=xs[1], h_lo=xs[2], p=bc(xs[3], _I32),
        last_ev=bc(xs[4], _I32), n_ev=bc(xs[5], _I32))
    return (stf, bc(xs[6], _I32), lp[:, :n_blk], lv[:, :n_blk],
            ll[:, :n_blk])


def _lane_count(n_real: int) -> int:
    """Lanes of a resolve: the real blocks padded once to the GPU
    sweep's block multiple (the pads sit after the real lanes and are
    never live, so the CPU path runs them at no cost to the result)."""
    return -(-n_real // _SWEEP_LB) * _SWEEP_LB


def _pad_lanes(a, n_blk: int):
    """Zero-pad the last (lane) axis to n_blk."""
    n = a.shape[-1]
    if n == n_blk:
        return a
    return jnp.concatenate(
        [a, jnp.zeros(a.shape[:-1] + (n_blk - n,), a.dtype)], axis=-1)


def _run_sweep(tT, j0, lastiv, W, n_blk, state0, start, end,
               active_lane, force_entry, thr_hi, thr_lo, capl):
    """Backend dispatch: the Triton kernel on the GPU, the XLA
    lax.scan + dense-to-list conversion on the CPU.

    Returns (exit_state, cnt, pos_list, pval_list, plast_list)."""
    if engine() == "gpu":
        return _sweep_triton(tT, j0, lastiv, W, n_blk, state0, start,
                             end, active_lane, force_entry, thr_hi,
                             thr_lo, capl)
    st, ev, pval, plast, isent = _sweep(tT, j0, lastiv, W, n_blk,
                                        state0, start, end, active_lane,
                                        force_entry, thr_hi, thr_lo)
    return (st,) + _lists_from_dense(ev, pval, plast, isent, j0, n_blk,
                                     capl)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def resolve_field(t: FieldTables, k: int, m: int, sel_cap: int,
                  entry, thr_hi, thr_lo):
    """Resolve the whole event chain from a FieldTables.

    entry: i32[8] machine state entering this region —
      [val|rev<<30 (bitcast), h_hi, h_lo, p, last_ev, n_ev_prior,
       unused, unused]; build with field_entry_init / carry rebasing.

    Returns one int32 fetch array:
      [status, n_sel, n_ev, last_ev_pos, tail_val, tail_rev, tail_sel,
       exit_val, exit_h_hi, exit_h_lo, exit_p, exit_last_ev,
       pos[cap], last[cap], val[cap], rev[cap]]
    status != 0 => unresolved blocks remain (caller must fall back).
    """
    W = k - m + 1
    P = t.h_hi.shape[0]
    n_real = P // _B
    B = _B
    n_blk = _lane_count(n_real)
    lanes = jnp.arange(n_blk, dtype=_I32)
    lane_base = lanes * B

    sync2 = _pad_lanes(t.sync.reshape(n_real, B).T, n_blk).T
    has_sync = jnp.any(sync2, axis=1)
    fs = jnp.argmax(sync2, axis=1).astype(_I32)
    fs = jnp.where(has_sync, fs, B)
    # lanes with no valid loop position are inert: resolved by fiat,
    # their (meaningless) exits only feed equally-inert successors
    live = lane_base <= t.last_i

    thr_hi = jnp.asarray(thr_hi, _U32).reshape(())
    thr_lo = jnp.asarray(thr_lo, _U32).reshape(())
    zst = FieldState(
        val=jnp.zeros((n_blk,), _U32),
        h_hi=jnp.full((n_blk,), 0xFFFFFFFF, _U32),
        h_lo=jnp.full((n_blk,), 0xFFFFFFFF, _U32),
        p=jnp.zeros((n_blk,), _I32),
        last_ev=jnp.full((n_blk,), -1, _I32),
        n_ev=jnp.zeros((n_blk,), _I32))
    tT = tuple(_pad_lanes(a, n_blk)
               for a in _transpose_tables(t, n_real))

    # per-lane selected-event list capacity: sized so the expected
    # occupancy (sel_cap spread over the lanes) has ~8x headroom;
    # overflowing lanes raise status and the caller falls back
    capl = min(128, max(16, _pow2_ge(
        -((-8 * sel_cap) // max(n_real, 1)))))

    lastiv = jnp.broadcast_to(t.last_i, (n_blk,)).astype(_I32)

    # ---- sweep 1: suffixes from each block's first sync ----
    st1, c_suf, suf_p, suf_v, suf_l = _run_sweep(
        tT, lane_base, lastiv, W, n_blk, zst, fs,
        jnp.full((n_blk,), B, _I32), has_sync, True, thr_hi, thr_lo,
        capl)

    exit_val = st1.val
    exit_hh = st1.h_hi
    exit_hl = st1.h_lo
    exit_p = st1.p
    exit_le = st1.last_ev
    suffix_ev = st1.n_ev
    exit_known = has_sync | ~live

    # ---- sweep 2 (iterated): prefixes from the predecessor's exit ----
    ent_val = jax.lax.bitcast_convert_type(entry[0], _U32).reshape(())
    ent_hh = jax.lax.bitcast_convert_type(entry[1], _U32).reshape(())
    ent_hl = jax.lax.bitcast_convert_type(entry[2], _U32).reshape(())
    ent_p = entry[3]
    ent_le = entry[4]

    def pred(a, first):
        return jnp.concatenate([jnp.asarray(first, a.dtype)[None],
                                a[:-1]])

    prefix_done = ~live
    prefix_ev = jnp.zeros((n_blk,), _I32)
    # state at the end of each lane's prefix (== pred exit when the
    # prefix has no events): the payload the lane's sync event closes
    pre_val = jnp.zeros((n_blk,), _U32)
    pre_le = jnp.full((n_blk,), -1, _I32)
    c_pre = jnp.zeros((n_blk,), _I32)
    pre_p = jnp.zeros((capl, n_blk), _I32)
    pre_v = jnp.zeros((capl, n_blk), _U32)
    pre_l = jnp.zeros((capl, n_blk), _I32)
    for _ in range(_MAX_PASSES):
        pred_known = pred(exit_known, True)
        can = ~prefix_done & pred_known
        st0 = FieldState(
            val=pred(exit_val, ent_val),
            h_hi=pred(exit_hh, ent_hh),
            h_lo=pred(exit_hl, ent_hl),
            p=pred(exit_p, ent_p),
            last_ev=pred(exit_le, ent_le),
            n_ev=jnp.zeros((n_blk,), _I32))
        st2, c2, p2, v2, l2 = _run_sweep(
            tT, lane_base, lastiv, W, n_blk, st0,
            jnp.zeros((n_blk,), _I32), fs, can, False, thr_hi, thr_lo,
            capl)
        canw = can[None, :]
        pre_p = jnp.where(canw, p2, pre_p)
        pre_v = jnp.where(canw, v2, pre_v)
        pre_l = jnp.where(canw, l2, pre_l)
        c_pre = jnp.where(can, c2, c_pre)
        prefix_ev = jnp.where(can, st2.n_ev, prefix_ev)
        pre_val = jnp.where(can, st2.val, pre_val)
        pre_le = jnp.where(can, st2.last_ev, pre_le)
        # syncless blocks: the "prefix" is the whole block; its end
        # state is the block exit
        newly_exit = can & ~has_sync
        exit_val = jnp.where(newly_exit, st2.val, exit_val)
        exit_hh = jnp.where(newly_exit, st2.h_hi, exit_hh)
        exit_hl = jnp.where(newly_exit, st2.h_lo, exit_hl)
        exit_p = jnp.where(newly_exit, st2.p, exit_p)
        exit_le = jnp.where(newly_exit, st2.last_ev, exit_le)
        exit_known = exit_known | newly_exit
        prefix_done = prefix_done | can
    # unresolved lanes, any per-lane list overflow, or an election
    # hash-collision flag all force the caller's exact fallback
    status = (jnp.sum(~prefix_done) + jnp.sum(c_suf > capl)
              + jnp.sum(c_pre > capl)
              + t.eflag.astype(_I32)).astype(_I32)

    # ---- synthesize the deferred entry emits: each sync event closes
    # the super-k-mer carried at the end of ITS OWN prefix (which
    # equals the predecessor's exit when the prefix had no events) ----
    e_sel = has_sync & ((pre_val >> 31) == 1)
    e_pos = lane_base + fs
    e_val = pre_val
    e_last = pre_le + 1

    # ---- selected-boundary extraction (9-tuple compact contract) ----
    # per lane, position order is: prefix list, entry event, suffix
    # list; lanes ascend, so concatenation order == global position
    # order. Output rank i maps to (lane, section, slot) through the
    # per-lane count prefix sums — every array here is sel_cap- or
    # n_blk-sized (no dense per-position nonzero).
    counts = c_pre + e_sel.astype(_I32) + c_suf
    n_sel = jnp.sum(counts).astype(_I32)
    n_ev = jnp.sum(suffix_ev) + jnp.sum(prefix_ev) + entry[5]

    offs = jnp.cumsum(counts)
    iidx = jnp.arange(sel_cap, dtype=_I32)
    lane_i = _rank_to_lane(offs, counts, sel_cap, n_blk)
    lane_c = jnp.clip(lane_i, 0, n_blk - 1).astype(_I32)
    base = offs[lane_c] - counts[lane_c]
    r_in = iidx - base
    cp = c_pre[lane_c]
    es = e_sel[lane_c]
    in_pre = r_in < cp
    is_ent = (r_in == cp) & es
    suf_slot = r_in - cp - es.astype(_I32)
    pre_idx = jnp.clip(r_in, 0, capl - 1) * n_blk + lane_c
    suf_idx = jnp.clip(suf_slot, 0, capl - 1) * n_blk + lane_c

    def pick(pre_a, e_a, suf_a):
        return jnp.where(
            in_pre, pre_a.reshape(-1)[pre_idx],
            jnp.where(is_ent, e_a[lane_c], suf_a.reshape(-1)[suf_idx]))

    ok = iidx < n_sel
    pos = jnp.where(ok, pick(pre_p, e_pos, suf_p), -1)
    last = jnp.where(ok, pick(pre_l, e_last, suf_l), -1)
    valw = jnp.where(ok, pick(pre_v, e_val, suf_v), 0)
    val = valw & ((1 << 30) - 1)
    rev = (valw >> 30) & 1

    # tail/carry: the LAST LIVE lane's exit (the machine state at
    # last_i); with no live lane the entry state passes through
    lane_q = jnp.clip(t.last_i // B, 0, n_blk - 1)
    no_live = t.last_i < 0
    x_val = jnp.where(no_live, ent_val, exit_val[lane_q])
    x_hh = jnp.where(no_live, ent_hh, exit_hh[lane_q])
    x_hl = jnp.where(no_live, ent_hl, exit_hl[lane_q])
    x_p = jnp.where(no_live, ent_p, exit_p[lane_q])
    x_le = jnp.where(no_live, ent_le, exit_le[lane_q])
    tail_val = x_val & ((1 << 30) - 1)
    tail_rev = (x_val >> 30) & 1
    tail_sel = (x_val >> 31) & 1
    last_ev_pos = x_le

    head = jnp.stack([
        status, n_sel, n_ev.astype(_I32), last_ev_pos,
        jax.lax.bitcast_convert_type(tail_val, _I32).reshape(()),
        tail_rev.astype(_I32), tail_sel.astype(_I32),
        jax.lax.bitcast_convert_type(x_val, _I32).reshape(()),
        jax.lax.bitcast_convert_type(x_hh, _I32).reshape(()),
        jax.lax.bitcast_convert_type(x_hl, _I32).reshape(()),
        x_p, x_le])
    return jnp.concatenate([
        head, pos, last,
        jax.lax.bitcast_convert_type(val, _I32), rev.astype(_I32)])


_HEAD = 12
_BHEAD = 8


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def resolve_field_batched(t: BatchedFieldTables, k: int, m: int,
                          sel_cap: int, P_rec: int, thr_hi, thr_lo):
    """Resolve the event chains of a whole record batch in one program.

    Every record is independent: lanes carry per-record local position
    frames (the generalized sweeps take per-lane j0/last_i), and the
    predecessor chaining of sweep 2 resets at record-head lanes to that
    record's window-0 entry election (reference SubSampler.cpp:359-365)
    instead of the previous lane's exit.

    Returns one int32 fetch array:
      [global_status, n_sel_total,
       B x _BHEAD per-record heads: (status, n_sel, n_ev, last_ev_pos,
                                     tail_val, tail_rev, tail_sel, 0),
       pos[sel_cap], last[sel_cap], val[sel_cap], rev[sel_cap]]
    where the sel lists are record-major (record b's events occupy the
    contiguous rank range given by the heads' n_sel prefix sums) and
    positions are LOCAL to each record. n_sel_total > sel_cap means
    truncated lists (caller re-dispatches with a bigger cap);
    status != 0 means unresolved/overflowed lanes in that record
    (caller falls back to the exact walker path for it)."""
    W = k - m + 1
    B = _B
    P = t.h_hi.shape[0]
    B_n = t.last_i.shape[0]
    lpr = P_rec // B             # lanes per record
    n_real = P // B
    n_blk = _lane_count(n_real)
    lanes = jnp.arange(n_blk, dtype=_I32)
    real = lanes < n_real
    lane_rec = jnp.minimum(lanes // lpr, B_n - 1)
    lane_base = (lanes % lpr) * B            # record-local
    lastiv = jnp.where(real, t.last_i[lane_rec], -1)
    is_head = (lanes % lpr == 0) & real

    sync2 = _pad_lanes(t.sync.reshape(n_real, B).T, n_blk).T
    has_sync = jnp.any(sync2, axis=1)
    fs = jnp.argmax(sync2, axis=1).astype(_I32)
    fs = jnp.where(has_sync, fs, B)
    live = (lane_base <= lastiv) & real

    thr_hi = jnp.asarray(thr_hi, _U32).reshape(())
    thr_lo = jnp.asarray(thr_lo, _U32).reshape(())
    zst = FieldState(
        val=jnp.zeros((n_blk,), _U32),
        h_hi=jnp.full((n_blk,), 0xFFFFFFFF, _U32),
        h_lo=jnp.full((n_blk,), 0xFFFFFFFF, _U32),
        p=jnp.zeros((n_blk,), _I32),
        last_ev=jnp.full((n_blk,), -1, _I32),
        n_ev=jnp.zeros((n_blk,), _I32))
    tT = tuple(_pad_lanes(a, n_blk)
               for a in _transpose_tables(t, n_real))

    capl = min(128, max(16, _pow2_ge(
        -((-8 * sel_cap) // max(n_real, 1)))))

    # ---- sweep 1: suffixes from each block's first sync ----
    st1, c_suf, suf_p, suf_v, suf_l = _run_sweep(
        tT, lane_base, lastiv, W, n_blk, zst, fs,
        jnp.full((n_blk,), B, _I32), has_sync, True, thr_hi, thr_lo,
        capl)

    exit_val = st1.val
    exit_hh = st1.h_hi
    exit_hl = st1.h_lo
    exit_p = st1.p
    exit_le = st1.last_ev
    suffix_ev = st1.n_ev
    exit_known = has_sync | ~live

    # ---- per-record entry elections (window 0, incl. sel bit) ----
    sel_e = ((t.init_h_hi < thr_hi)
             | ((t.init_h_hi == thr_hi) & (t.init_h_lo <= thr_lo)))
    ent_val_r = t.init_val | (sel_e.astype(_U32) << 31)   # (B_n,)
    ev_val = ent_val_r[lane_rec]
    ev_hh = t.init_h_hi[lane_rec]
    ev_hl = t.init_h_lo[lane_rec]
    ev_p = t.init_p[lane_rec]
    ev_le = jnp.full((n_blk,), -1, _I32)

    def pred(a, headv):
        sh = jnp.concatenate([a[:1], a[:-1]])
        return jnp.where(is_head, headv, sh)

    # ---- sweep 2 (iterated): prefixes from the predecessor's exit,
    # record-head lanes from their record's entry ----
    prefix_done = ~live
    prefix_ev = jnp.zeros((n_blk,), _I32)
    pre_val = jnp.zeros((n_blk,), _U32)
    pre_le = jnp.full((n_blk,), -1, _I32)
    c_pre = jnp.zeros((n_blk,), _I32)
    pre_p = jnp.zeros((capl, n_blk), _I32)
    pre_v = jnp.zeros((capl, n_blk), _U32)
    pre_l = jnp.zeros((capl, n_blk), _I32)
    true_head = jnp.ones((n_blk,), bool)
    for _ in range(_MAX_PASSES):
        pred_known = pred(exit_known, true_head)
        can = ~prefix_done & pred_known
        st0 = FieldState(
            val=pred(exit_val, ev_val),
            h_hi=pred(exit_hh, ev_hh),
            h_lo=pred(exit_hl, ev_hl),
            p=pred(exit_p, ev_p),
            last_ev=pred(exit_le, ev_le),
            n_ev=jnp.zeros((n_blk,), _I32))
        st2, c2, p2, v2, l2 = _run_sweep(
            tT, lane_base, lastiv, W, n_blk, st0,
            jnp.zeros((n_blk,), _I32), fs, can, False, thr_hi, thr_lo,
            capl)
        canw = can[None, :]
        pre_p = jnp.where(canw, p2, pre_p)
        pre_v = jnp.where(canw, v2, pre_v)
        pre_l = jnp.where(canw, l2, pre_l)
        c_pre = jnp.where(can, c2, c_pre)
        prefix_ev = jnp.where(can, st2.n_ev, prefix_ev)
        pre_val = jnp.where(can, st2.val, pre_val)
        pre_le = jnp.where(can, st2.last_ev, pre_le)
        newly_exit = can & ~has_sync
        exit_val = jnp.where(newly_exit, st2.val, exit_val)
        exit_hh = jnp.where(newly_exit, st2.h_hi, exit_hh)
        exit_hl = jnp.where(newly_exit, st2.h_lo, exit_hl)
        exit_p = jnp.where(newly_exit, st2.p, exit_p)
        exit_le = jnp.where(newly_exit, st2.last_ev, exit_le)
        exit_known = exit_known | newly_exit
        prefix_done = prefix_done | can

    bad_lane = ((~prefix_done) | (c_suf > capl)
                | (c_pre > capl)).astype(_I32)
    status_rec = jax.ops.segment_sum(bad_lane, lane_rec,
                                     num_segments=B_n)
    # election hash-collision flag: that record takes the exact
    # standalone fallback
    status_rec = status_rec + t.eflag.astype(_I32)

    # ---- deferred entry emits (sync events closing their own
    # prefix's payload) ----
    e_sel = has_sync & ((pre_val >> 31) == 1)
    e_pos = lane_base + fs
    e_val = pre_val
    e_last = pre_le + 1

    counts = c_pre + e_sel.astype(_I32) + c_suf
    n_sel = jnp.sum(counts).astype(_I32)
    n_sel_rec = jax.ops.segment_sum(counts, lane_rec,
                                    num_segments=B_n)
    n_ev_rec = jax.ops.segment_sum(suffix_ev + prefix_ev, lane_rec,
                                   num_segments=B_n)

    # ---- selected-boundary extraction (record-major global ranks) ----
    offs = jnp.cumsum(counts)
    iidx = jnp.arange(sel_cap, dtype=_I32)
    lane_i = _rank_to_lane(offs, counts, sel_cap, n_blk)
    lane_c = jnp.clip(lane_i, 0, n_blk - 1).astype(_I32)
    base = offs[lane_c] - counts[lane_c]
    r_in = iidx - base
    cp = c_pre[lane_c]
    es = e_sel[lane_c]
    in_pre = r_in < cp
    is_ent = (r_in == cp) & es
    suf_slot = r_in - cp - es.astype(_I32)
    pre_idx = jnp.clip(r_in, 0, capl - 1) * n_blk + lane_c
    suf_idx = jnp.clip(suf_slot, 0, capl - 1) * n_blk + lane_c

    def pick(pre_a, e_a, suf_a):
        return jnp.where(
            in_pre, pre_a.reshape(-1)[pre_idx],
            jnp.where(is_ent, e_a[lane_c], suf_a.reshape(-1)[suf_idx]))

    ok = iidx < n_sel
    pos = jnp.where(ok, pick(pre_p, e_pos, suf_p), -1)
    last = jnp.where(ok, pick(pre_l, e_last, suf_l), -1)
    valw = jnp.where(ok, pick(pre_v, e_val, suf_v), 0)
    val = valw & ((1 << 30) - 1)
    rev = (valw >> 30) & 1

    # ---- per-record tails: the LAST LIVE lane's exit ----
    lane_q = (jnp.arange(B_n, dtype=_I32) * lpr
              + jnp.clip(t.last_i // B, 0, lpr - 1))
    no_live = t.last_i < 0
    x_val = jnp.where(no_live, ent_val_r, exit_val[lane_q])
    x_le = jnp.where(no_live, jnp.int32(-1), exit_le[lane_q])
    tail_val = x_val & ((1 << 30) - 1)
    tail_rev = (x_val >> 30) & 1
    tail_sel = (x_val >> 31) & 1

    heads = jnp.stack([
        status_rec.astype(_I32), n_sel_rec.astype(_I32),
        n_ev_rec.astype(_I32), x_le,
        jax.lax.bitcast_convert_type(tail_val, _I32),
        tail_rev.astype(_I32), tail_sel.astype(_I32),
        jnp.zeros((B_n,), _I32)], axis=1)          # (B_n, _BHEAD)
    g = jnp.stack([jnp.sum(status_rec).astype(_I32), n_sel])
    return jnp.concatenate([
        g, heads.reshape(-1), pos, last,
        jax.lax.bitcast_convert_type(val, _I32), rev.astype(_I32)])


def parse_batched_heads(arr: np.ndarray, cap: int, B_n: int):
    """Zero-copy split of resolve_field_batched's fetch array:
    (global_status, n_sel_total, heads (B_n, _BHEAD) i32, pos, last,
    val u32, rev) — no per-record slicing (the batch-granular assembly
    path slices runs itself). Truncation (n_total > cap) returns None
    bodies; caller re-dispatches with a bigger cap."""
    gstatus = int(arr[0])
    n_total = int(arr[1])
    heads = arr[2 : 2 + _BHEAD * B_n].reshape(B_n, _BHEAD)
    if n_total > cap:
        return gstatus, n_total, heads, None, None, None, None
    body = arr[2 + _BHEAD * B_n:]
    return (gstatus, n_total, heads, body[:cap], body[cap : 2 * cap],
            body[2 * cap : 3 * cap].view(np.uint32),
            body[3 * cap : 4 * cap])


def parse_batched_array(arr: np.ndarray, cap: int, B_n: int):
    """Host-side split of resolve_field_batched's fetch array into
    (global_status, n_sel_total, per-record compact 9-tuples,
    per-record n_sel). Truncation (n_sel_total > cap) returns comps
    None — caller must re-dispatch with a bigger cap."""
    gstatus = int(arr[0])
    n_total = int(arr[1])
    if n_total > cap:
        return gstatus, n_total, None, None
    heads = arr[2 : 2 + _BHEAD * B_n].reshape(B_n, _BHEAD)
    body = arr[2 + _BHEAD * B_n:]
    pos = body[:cap]
    last = body[cap : 2 * cap]
    val = body[2 * cap : 3 * cap].view(np.uint32)
    rev = body[3 * cap : 4 * cap]
    n_sel_rec = heads[:, 1].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(n_sel_rec)])
    comps = []
    for b in range(B_n):
        s, e = int(offs[b]), int(offs[b + 1])
        comps.append((
            pos[s:e].astype(np.int64), last[s:e].astype(np.int64),
            val[s:e], rev[s:e] != 0, int(heads[b, 2]),
            int(heads[b, 3]), int(np.int64(heads[b, 4]) & 0xFFFFFFFF),
            bool(heads[b, 5]), bool(heads[b, 6])))
    return gstatus, n_total, comps, heads[:, 0].astype(np.int64)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def scan_resolve_batch(packed, k: int, m: int, P_rec: int,
                       sel_cap: int, lengths, thr_hi, thr_lo):
    """Fused batch dispatch: scan + resolve of a (B, P_rec//4) packed
    record batch as ONE program — one dispatch and one D2H fetch for
    the whole batch (the many-short-record path; reference streams any
    record shape through one loop, SubSampler.cpp:334-347)."""
    t = scan_field_batched(packed, k, m, P_rec, lengths)
    return resolve_field_batched(t, k, m, sel_cap, P_rec, thr_hi,
                                 thr_lo)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def scan_resolve_single(slab, k: int, m: int, P: int, sel_cap: int,
                        length, thr_hi, thr_lo):
    """Fused single-tile dispatch: unpack + field scan + entry + full
    resolution as ONE jit program (the intermediate FieldTables never
    materialize as separate dispatch boundaries). The GPU path; the
    CPU splits it into three dispatches, which compile faster.

    slab: the 128-position-halo'd packed byte array of a single-tile
    record ((128 + P) / 4 bytes); the halo is sliced off on device
    (XLA fuses the slice into the unpack). Returns resolve_field's
    fetch array."""
    t = scan_field_2d_packed(slab[32:], k, m, P, length, True)
    entry = field_entry_init(t, thr_hi, thr_lo)
    return resolve_field(t, k, m, sel_cap, entry, thr_hi, thr_lo)


@jax.jit
def field_entry_init(t: FieldTables, thr_hi, thr_lo):
    """Entry state for the first region of a sequence: the window-0
    election (reference SubSampler.cpp:359-365), its sel bit included."""
    thr_hi = jnp.asarray(thr_hi, _U32).reshape(())
    thr_lo = jnp.asarray(thr_lo, _U32).reshape(())
    sel = ((t.init_h_hi < thr_hi)
           | ((t.init_h_hi == thr_hi) & (t.init_h_lo <= thr_lo)))
    val = t.init_val | (sel.astype(_U32) << 31)
    z = jnp.int32(0)
    return jnp.stack([
        jax.lax.bitcast_convert_type(val, _I32).reshape(()),
        jax.lax.bitcast_convert_type(t.init_h_hi, _I32).reshape(()),
        jax.lax.bitcast_convert_type(t.init_h_lo, _I32).reshape(()),
        t.init_p.astype(_I32), jnp.int32(-1), z, z, z])


@functools.partial(jax.jit, static_argnums=(1,))
def field_carry(arr, own: int):
    """Next tile's entry from this region's fetch array: the exit
    state re-based by -own (positions go local to the next tile)."""
    z = jnp.int32(0)
    return jnp.stack([
        arr[7], arr[8], arr[9], arr[10] - own, arr[11] - own, z, z, z])


@jax.jit
def field_entry_to_walker_init(t: FieldTables, entry):
    """Convert a field-machine entry state into the legacy walker's
    entering chain state (init5, fb) for the SAME region.

    The walker needs the position/type of the first event in the
    region; the field tables supply it directly: the first adoption is
    the first position whose entering hash strictly undercuts the held
    hash (reference SubSampler.cpp:374-388), the expiry fires at the
    first position >= position_min (SubSampler.cpp:391-399), and at a
    shared position adoption wins (the reference checks it first).
    Enables tile-granular fallback: a tile whose sync resolution
    overflows re-runs through the exact walker without re-running its
    predecessors."""
    P = t.h_hi.shape[0]
    hh = jax.lax.bitcast_convert_type(entry[1], _U32).reshape(())
    hl = jax.lax.bitcast_convert_type(entry[2], _U32).reshape(())
    j = jnp.arange(P, dtype=_I32)
    lt = (t.h_hi < hh) | ((t.h_hi == hh) & (t.h_lo < hl))
    valid = lt & (j <= t.last_i)
    big = jnp.int32(P)
    j_adopt = jnp.min(jnp.where(valid, j, big))
    p = entry[3]
    j_exp = jnp.where(p <= t.last_i, jnp.maximum(p, 0), big)
    npos = jnp.minimum(j_adopt, j_exp)
    ntyp = jnp.where(j_adopt <= j_exp, 0, 1).astype(_I32)
    has = npos <= t.last_i
    val_bits = jax.lax.bitcast_convert_type(entry[0], _U32).reshape(())
    sel = ((val_bits >> 31) & 1).astype(_I32)
    # cur_pos = the entry's (negative, local) last-event position: the
    # first emit's last_position is cur_pos + 1, i.e. the open
    # super-k-mer's start carried over from the previous tile
    init5 = jnp.stack([
        jnp.where(has, npos, -1).astype(_I32), ntyp, sel,
        entry[4].astype(_I32), jnp.int32(0)])
    fb = jnp.stack([
        jax.lax.bitcast_convert_type(
            val_bits & ((1 << 30) - 1), _I32).reshape(()),
        ((val_bits >> 30) & 1).astype(_I32)])
    return init5, fb


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def walker_exit_to_field_entry(t: FieldTables, scal, entry, k: int,
                               m: int, own: int, thr_hi, thr_lo):
    """Convert the walker's exit state after a fallback tile back into
    the NEXT tile's field entry (re-based by -own).

    scal: the walker's [n_ev, cur_pos, cur_typ, cur_sel, ...] final
    snapshot. The held minimizer's value/hash/position_min come from
    the field tables at the last event: an adoption at j holds the
    entering m-mer (val=cv[j], hash=h[j], p=j+W); a rescan holds the
    window election (em/eh[j], p=ep[j]+j+1 — the reference's
    position_min += i+1 quirk, SubSampler.cpp:397). With no event in
    the walk the entry passes through re-based."""
    W = k - m + 1
    P = t.h_hi.shape[0]
    cur_pos, cur_typ = scal[1], scal[2]
    no_ev = cur_pos < 0
    pc = jnp.clip(cur_pos, 0, P - 1)
    isA = cur_typ == 0
    val = jnp.where(isA, t.cv[pc], t.em[pc])
    hh = jnp.where(isA, t.h_hi[pc], t.eh_hi[pc])
    hl = jnp.where(isA, t.h_lo[pc], t.eh_lo[pc])
    p_new = jnp.where(isA, pc + W, t.ep[pc] + pc + 1)
    thr_hi = jnp.asarray(thr_hi, _U32).reshape(())
    thr_lo = jnp.asarray(thr_lo, _U32).reshape(())
    sel = ((hh < thr_hi) | ((hh == thr_hi) & (hl <= thr_lo)))
    valb = val | (sel.astype(_U32) << 31)
    e_val = jnp.where(no_ev,
                      jax.lax.bitcast_convert_type(entry[0], _U32)
                      .reshape(()), valb)
    e_hh = jnp.where(no_ev,
                     jax.lax.bitcast_convert_type(entry[1], _U32)
                     .reshape(()), hh)
    e_hl = jnp.where(no_ev,
                     jax.lax.bitcast_convert_type(entry[2], _U32)
                     .reshape(()), hl)
    e_p = jnp.where(no_ev, entry[3], p_new) - own
    e_le = jnp.where(no_ev, entry[4], cur_pos) - own
    z = jnp.int32(0)
    return jnp.stack([
        jax.lax.bitcast_convert_type(e_val, _I32).reshape(()),
        jax.lax.bitcast_convert_type(e_hh, _I32).reshape(()),
        jax.lax.bitcast_convert_type(e_hl, _I32).reshape(()),
        e_p.astype(_I32), e_le.astype(_I32), z, z, z])


def parse_field_array(arr: np.ndarray, cap: int):
    """Host-side split into (status, compact-9-tuple, n_sel)."""
    status = int(arr[0])
    n_sel = int(arr[1])
    body = arr[_HEAD : _HEAD + 4 * cap]
    sel_pos = body[:n_sel].astype(np.int64)
    sel_last = body[cap : cap + n_sel].astype(np.int64)
    sel_val = body[2 * cap : 2 * cap + n_sel].view(np.uint32)
    sel_rev = body[3 * cap : 3 * cap + n_sel] != 0
    comp = (sel_pos, sel_last, sel_val, sel_rev, int(arr[2]),
            int(arr[3]), int(np.int64(arr[4]) & 0xFFFFFFFF),
            bool(arr[5]), bool(arr[6]))
    return status, comp, n_sel
