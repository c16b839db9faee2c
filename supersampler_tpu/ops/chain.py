"""Pointer-doubling event-chain extraction — the walker's TEST ORACLE.

An O(log n)-rounds chain extractor over whole-sequence ScanTables,
written independently of the walks in ops/walker.py (which take a
carried entry state and a truncated walk length). tests/test_walker.py
checks the walker against it: two very different algorithms agreeing
on fuzzed inputs.

Reference semantics replayed here: the super-k-mer boundary loop of
Subsampler::parse_fasta_test (reference SubSampler.cpp:401-454).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from supersampler_tpu.ops.minimizer import ScanTables

_I32 = jnp.int32


class ChainStage1(NamedTuple):
    """Device-resident chain state after pointer doubling."""

    states: jnp.ndarray      # int32[cap], s = 2*pos + type, -1 past end
    ev_pos: jnp.ndarray      # int32[cap], event positions (garbage past n_ev)
    prev_sel: jnp.ndarray    # bool[cap], boundary closes a selected skmer
    prev_val: jnp.ndarray    # uint32[cap], minimizer of the closed skmer
    prev_rev: jnp.ndarray    # bool[cap]
    n_ev: jnp.ndarray        # int32 scalar, number of events
    n_sel: jnp.ndarray       # int32 scalar, number of selected boundaries
    last_ev_pos: jnp.ndarray  # int32, position of final event (-1 if none)
    tail_val: jnp.ndarray    # uint32, payload live at end of sequence
    tail_rev: jnp.ndarray    # bool
    tail_sel: jnp.ndarray    # bool


class SelectedBoundaries(NamedTuple):
    """Compacted selected boundaries (the only bulk host transfer)."""

    pos: jnp.ndarray   # int32[sel_cap], boundary position i (-1 padding)
    last: jnp.ndarray  # int32[sel_cap], last_position (skmer start)
    val: jnp.ndarray   # uint32[sel_cap], minimizer value
    rev: jnp.ndarray   # bool[sel_cap]


def _interleave_succ(t: ScanTables) -> jnp.ndarray:
    """succ[2p + ty] -> next state (or -1), ty 0=adoption 1=rescan."""
    sa = jnp.where(t.nxt_pos_a >= 0,
                   2 * t.nxt_pos_a + jnp.where(t.nxt_adopt_a, 0, 1),
                   -1).astype(_I32)
    sr = jnp.where(t.nxt_pos_r >= 0,
                   2 * t.nxt_pos_r + jnp.where(t.nxt_adopt_r, 0, 1),
                   -1).astype(_I32)
    return jnp.stack([sa, sr], axis=1).reshape(-1)


def chain_stage1(t: ScanTables, capacity: int) -> ChainStage1:
    """Extract the full event chain by pointer doubling.

    capacity must be a power of two >= n_loop so the chain can never
    overflow (events sit at strictly increasing positions).
    """
    n = t.nxt_pos_a.shape[0]
    succ = _interleave_succ(t)
    two_n = 2 * n

    init_s = jnp.where(
        t.init_nxt_pos >= 0,
        2 * t.init_nxt_pos + jnp.where(t.init_nxt_adopt, 0, 1),
        -1).astype(_I32)

    out = jnp.full((capacity,), -1, _I32).at[0].set(init_s)
    step = 1
    A = succ
    while step < capacity:
        take = min(step, capacity - step)
        cur = jax.lax.slice(out, (0,), (take,))
        nxt = jnp.where(cur >= 0, A[jnp.clip(cur, 0, two_n - 1)], -1)
        out = jax.lax.dynamic_update_slice(out, nxt, (step,))
        step *= 2
        if step < capacity:
            A = jnp.where(A >= 0, A[jnp.clip(A, 0, two_n - 1)], -1)

    valid = out >= 0
    n_ev = jnp.sum(valid).astype(_I32)
    pos = jnp.where(valid, out >> 1, -1)
    is_adopt = (out & 1) == 0
    pc = jnp.clip(pos, 0, n - 1)
    ev_val = jnp.where(is_adopt, t.val_a[pc], t.val_r[pc])
    ev_rev = jnp.where(is_adopt, t.rev_a[pc], t.rev_r[pc])
    ev_sel = jnp.where(is_adopt, t.sel_a[pc], t.sel_r[pc])

    # boundary j closes the super-k-mer carrying event j-1's payload
    # (or the initial election's, SubSampler.cpp:401-426)
    prev_val = jnp.concatenate(
        [t.init_val.astype(jnp.uint32)[None], ev_val[:-1]])
    prev_rev = jnp.concatenate([t.init_rev[None], ev_rev[:-1]])
    prev_sel = jnp.concatenate([t.init_sel[None], ev_sel[:-1]]) & valid
    n_sel = jnp.sum(prev_sel).astype(_I32)

    ln = jnp.clip(n_ev - 1, 0, capacity - 1)
    has = n_ev > 0
    last_ev_pos = jnp.where(has, pos[ln], -1)
    tail_val = jnp.where(has, ev_val[ln], t.init_val.astype(jnp.uint32))
    tail_rev = jnp.where(has, ev_rev[ln], t.init_rev)
    tail_sel = jnp.where(has, ev_sel[ln], t.init_sel)

    return ChainStage1(out, pos, prev_sel, prev_val, prev_rev, n_ev,
                       n_sel, last_ev_pos, tail_val, tail_rev, tail_sel)


def chain_stage2(s1: ChainStage1, sel_cap: int) -> SelectedBoundaries:
    """Compact the selected boundaries into sel_cap slots."""
    idx = jnp.nonzero(s1.prev_sel, size=sel_cap, fill_value=-1)[0]
    ok = idx >= 0
    ic = jnp.clip(idx, 0, s1.ev_pos.shape[0] - 1)
    pos = jnp.where(ok, s1.ev_pos[ic], -1)
    last = jnp.where(idx > 0, s1.ev_pos[jnp.clip(ic - 1, 0, None)] + 1, 0)
    last = jnp.where(ok, last, -1)
    val = s1.prev_val[ic]
    rev = s1.prev_rev[ic]
    return SelectedBoundaries(pos, last, val, rev)


_stage1_jit = jax.jit(chain_stage1, static_argnums=(1,))
_stage2_jit = jax.jit(chain_stage2, static_argnums=(1,))


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def compact_from_stage1(s1: ChainStage1):
    """Stage-2 compaction + host fetch of the tiny selected set.

    Returns (sel_pos, sel_last, sel_val, sel_rev, n_ev, last_ev_pos,
    tail_val, tail_rev, tail_sel) with arrays trimmed to n_sel.
    """
    n_sel = int(s1.n_sel)           # tiny scalar sync
    sel_cap = _pow2_at_least(max(n_sel, 16))
    sb = _stage2_jit(s1, sel_cap)
    sel_pos = np.asarray(sb.pos)[:n_sel].astype(np.int64)
    sel_last = np.asarray(sb.last)[:n_sel].astype(np.int64)
    sel_val = np.asarray(sb.val)[:n_sel]
    sel_rev = np.asarray(sb.rev)[:n_sel]
    return (sel_pos, sel_last, sel_val, sel_rev, int(s1.n_ev),
            int(s1.last_ev_pos), int(s1.tail_val), bool(s1.tail_rev),
            bool(s1.tail_sel))


def compact_chain(t: ScanTables):
    """Run both stages; returns host-side numpy compact results."""
    cap = _pow2_at_least(max(int(t.nxt_pos_a.shape[0]), 2))
    return compact_from_stage1(_stage1_jit(t, cap))
