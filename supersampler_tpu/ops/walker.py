"""Event-chain walker: the exact fallback of the sync-field engine.

The minimizer scan (ops/minimizer.py) leaves per-position successor
tables on the device; the super-k-mer boundary chain is their
transitive walk from the initial election (reference
SubSampler.cpp:367-454). Successor entries are packed to one int32 per
position, and the walk emits the FHS-selected boundaries (the only data
the host needs) into one compact array. Two walks share that contract:

- `walk_xla`: the chain chased serially in one `lax.while_loop`, one
  iteration per event (the CPU path: XLA's CPU backend runs the loop
  natively);
- `walk_doubling`: the same chain extracted by pointer doubling in
  O(log n) data-parallel rounds (the GPU path: a GPU pays a loop
  iteration per event at launch scale, a gather round at bandwidth).

Packed word layout (bit positions), per loop position j — the two
node types occupy symmetric 16-bit halves so a walk decodes with
ONE variable shift (h = w >> (typ*16)) instead of per-field selects:
  [0:6]   delta_a   next-event distance from the A(doption) node (0 = none)
  [6]     typ_a     next event type from the A node (0=A, 1=R(escan))
  [7]     sel_a     FHS-selected bit of the A node's payload
  [16:22] delta_r   same three fields for the R node
  [22]    typ_r
  [23]    sel_r
(k-m+1 <= 61 for k <= 63, so deltas fit 6 bits.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from supersampler_tpu.backend import engine
from supersampler_tpu.ops.minimizer import ScanTables

_I32 = jnp.int32
_BP = 2048            # walk lengths (n_pad) are multiples of this


def pack_succ(t: ScanTables, n_pad: int) -> jnp.ndarray:
    """Pack both successor tables + sel bits into one int32 per position,
    zero-padded (delta 0 = chain ends) or truncated to n_pad. Truncation
    is the tiled path: positions >= n_pad belong to the next tile's
    tables; successor targets may still point past n_pad (the carry)."""
    n = t.nxt_pos_a.shape[0]
    j = jnp.arange(n, dtype=_I32)
    da = jnp.where(t.nxt_pos_a >= 0, t.nxt_pos_a - j, 0)
    dr = jnp.where(t.nxt_pos_r >= 0, t.nxt_pos_r - j, 0)
    ta = jnp.where(t.nxt_adopt_a, 0, 1)
    tr = jnp.where(t.nxt_adopt_r, 0, 1)
    w = (da | (ta << 6) | (t.sel_a.astype(_I32) << 7)
         | (dr << 16) | (tr << 22) | (t.sel_r.astype(_I32) << 23))
    if n_pad > n:
        return jnp.concatenate([w, jnp.zeros((n_pad - n,), _I32)])
    return w[:n_pad]


def make_init5(init_nxt_pos, init_nxt_typ, init_sel,
               cur_pos=-1, cur_typ=0) -> jnp.ndarray:
    """Entering chain state for a walk (see _walk_kernel)."""
    return jnp.stack([
        jnp.asarray(init_nxt_pos, _I32).reshape(()),
        jnp.asarray(init_nxt_typ, _I32).reshape(()),
        jnp.asarray(init_sel, _I32).reshape(()),
        jnp.asarray(cur_pos, _I32).reshape(()),
        jnp.asarray(cur_typ, _I32).reshape(()),
    ])


def walk_xla(packed: jnp.ndarray, init5: jnp.ndarray):
    """Serial chain walk as a single lax.while_loop (the CPU path).

    packed: int32[n_pad] (pack_succ); init5: the entering chain state
    [nxt_pos, nxt_typ, cur_sel, cur_pos, cur_typ] (make_init5). The
    walk visits events at positions < n_pad; the first one beyond is
    the carry.

    Returns (ei, el, es) (1, n_pad) int32 — per selected boundary its
    position, last_position and source state (2*pos + typ, or -1 for
    the entering payload), -1 past cnt — plus cnt (1,) and scal
    [n_ev, last_pos, last_typ, tail_sel, nxt_pos, nxt_typ]."""
    n_pad = packed.shape[0]
    ei0 = jnp.full((n_pad,), -1, _I32)

    def cond(c):
        return (c[3] >= 0) & (c[3] < n_pad)

    def body(c):
        cur_pos, cur_typ, cur_sel, npos, ntyp, n_ev, cnt, ei, el, es = c
        emit = cur_sel != 0
        src = jnp.where(cur_pos < 0, -1, 2 * cur_pos + cur_typ)
        # O(1) conditional store: keep the old value when not emitting
        ei = ei.at[cnt].set(jnp.where(emit, npos, ei[cnt]))
        el = el.at[cnt].set(jnp.where(emit, cur_pos + 1, el[cnt]))
        es = es.at[cnt].set(jnp.where(emit, src, es[cnt]))
        w = packed[npos]
        h = w >> (ntyp << 4)
        delta = h & 63
        return (npos, ntyp, (h >> 7) & 1,
                jnp.where(delta > 0, npos + delta, -1), (h >> 6) & 1,
                n_ev + 1, cnt + emit.astype(_I32), ei, el, es)

    init = (init5[3], init5[4], init5[2], init5[0], init5[1],
            jnp.int32(0), jnp.int32(0), ei0, ei0, ei0)
    (cur_pos, cur_typ, cur_sel, npos, ntyp, n_ev, cnt, ei, el,
     es) = jax.lax.while_loop(cond, body, init)
    scal = jnp.stack([n_ev, cur_pos, cur_typ, cur_sel, npos, ntyp])
    return (ei.reshape(1, n_pad), el.reshape(1, n_pad),
            es.reshape(1, n_pad), cnt.reshape(1), scal)


def walk_doubling(packed: jnp.ndarray, init5: jnp.ndarray):
    """The walk of walk_xla by pointer doubling, same contract and
    bytes.

    States s = 2*pos + typ. f(s) is the successor state inside the walk
    (-1 when the chain ends or leaves [0, n_pad)); log2(n_pad) rounds
    of f composed with itself list every event e_i = f^i(e_0) from the
    entering next-event state e_0 (events sit at strictly increasing
    positions, so there are at most n_pad). Each event's emit then
    follows from its predecessor's state and sel bit, and one
    cumsum-scatter compacts the selected boundaries."""
    n_pad = packed.shape[0]
    cap = _pow2_ge(n_pad)
    two_n = 2 * n_pad
    st = jnp.arange(two_n, dtype=_I32)
    pos = st >> 1
    typ = st & 1
    h = packed[pos] >> (typ << 4)
    delta = h & 63
    npos = pos + delta
    f = jnp.where((delta > 0) & (npos < n_pad),
                  2 * npos + ((h >> 6) & 1), -1)

    def look(a, x):
        return jnp.where(x >= 0, a[jnp.clip(x, 0, two_n - 1)], -1)

    s0 = jnp.where((init5[0] >= 0) & (init5[0] < n_pad),
                   2 * init5[0] + init5[1], -1).astype(_I32)
    out = jnp.full((cap,), -1, _I32).at[0].set(s0)
    step = 1
    a = f
    while step < cap:
        take = min(step, cap - step)
        out = jax.lax.dynamic_update_slice(
            out, look(a, out[:take]), (step,))
        step *= 2
        if step < cap:
            a = look(a, a)

    valid = out >= 0
    n_ev = jnp.sum(valid).astype(_I32)
    ev_pos = jnp.where(valid, out >> 1, -1)
    oc = jnp.clip(out, 0, two_n - 1)
    ev_h = jnp.where(valid, h[oc], 0)
    ev_sel = (ev_h >> 7) & 1
    # event i closes the super-k-mer of event i-1 (the entering state
    # for i = 0)
    prev_state = jnp.concatenate([
        jnp.where(init5[3] < 0, -1,
                  2 * init5[3] + init5[4]).astype(_I32)[None],
        out[:-1]])
    prev_pos = jnp.concatenate([init5[3][None], ev_pos[:-1]])
    prev_sel = jnp.concatenate([init5[2][None], ev_sel[:-1]])
    emit = valid & (prev_sel != 0)
    cnt = jnp.sum(emit).astype(_I32)
    slot = jnp.where(emit, jnp.cumsum(emit.astype(_I32)) - 1, n_pad)
    fill = jnp.full((n_pad,), -1, _I32)
    ei = fill.at[slot].set(ev_pos, mode="drop")
    el = fill.at[slot].set(prev_pos + 1, mode="drop")
    es = fill.at[slot].set(prev_state, mode="drop")

    # final state: the last event (or the entering state when the walk
    # has none) and the next event its word points at
    last = jnp.clip(n_ev - 1, 0, cap - 1)
    has = n_ev > 0
    lh = ev_h[last]
    l_pos = ev_pos[last]
    l_delta = lh & 63
    scal = jnp.stack([
        n_ev,
        jnp.where(has, l_pos, init5[3]),
        jnp.where(has, out[last] & 1, init5[4]),
        jnp.where(has, ev_sel[last], init5[2]),
        jnp.where(has, jnp.where(l_delta > 0, l_pos + l_delta, -1),
                  init5[0]),
        jnp.where(has, (lh >> 6) & 1, init5[1])]).astype(_I32)
    return (ei.reshape(1, n_pad), el.reshape(1, n_pad),
            es.reshape(1, n_pad), cnt.reshape(1), scal)


def _walk_from_tables(t: ScanTables, init5, n_pad: int):
    packed = pack_succ(t, n_pad)
    walk = walk_doubling if engine() == "gpu" else walk_xla
    ei, el, es, cnt, scal = walk(packed, init5)
    n_sel = jnp.sum(cnt).astype(_I32)
    return ei, el, es, cnt, scal, n_sel


def pack_compact_outs(outs, scal):
    """Bundle _compact_emits outputs into one int32 fetch array:
    [n_sel, n_ev, last_pos, tail_val, tail_rev, tail_sel, nxt_pos,
     nxt_typ, pos[cap], last[cap], val[cap], rev[cap]] — everything
    the host needs per walk rides one transfer."""
    (pos, last, val, rev, n_sel, n_ev, last_pos, tail_val, tail_rev,
     tail_sel) = outs
    head = jnp.stack([
        n_sel.astype(_I32), n_ev.astype(_I32), last_pos.astype(_I32),
        jax.lax.bitcast_convert_type(tail_val, _I32).reshape(()),
        tail_rev.astype(_I32), tail_sel.astype(_I32),
        scal[4], scal[5],
    ])
    return jnp.concatenate([
        head, pos, last, jax.lax.bitcast_convert_type(val, _I32),
        rev.astype(_I32)])


def _compact_packed(ei, el, es, cnt, scal, t: ScanTables, sel_cap: int,
                    fb_val, fb_rev):
    outs = _compact_emits(ei, el, es, cnt, scal, t, sel_cap,
                          fb_val, fb_rev)
    return pack_compact_outs(outs, scal)


def _compact_emits(ei, el, es, cnt, scal, t: ScanTables, sel_cap: int,
                   fb_val, fb_rev):
    """Flatten the per-block emit tiles into sel_cap slots and gather the
    minimizer payloads (value/strand) of each selected boundary + tail.

    (fb_val, fb_rev) is the payload of super-k-mers whose opening event
    precedes this walk (src < 0): the scan's initial election for the
    first tile of a sequence, the carried payload for later tiles.
    """
    n_blocks, bp = ei.shape
    cum = jnp.cumsum(cnt)
    n_sel = cum[-1]
    s = jnp.arange(sel_cap, dtype=_I32)
    blk = jnp.searchsorted(cum, s, side="right").astype(_I32)
    blk_c = jnp.clip(blk, 0, n_blocks - 1)
    prev = jnp.where(blk_c > 0, cum[jnp.clip(blk_c - 1, 0, None)], 0)
    row = jnp.clip(s - prev, 0, bp - 1)
    ok = s < n_sel
    flat_idx = blk_c * bp + row
    pos = jnp.where(ok, ei.reshape(-1)[flat_idx], -1)
    last = jnp.where(ok, el.reshape(-1)[flat_idx], -1)
    src = jnp.where(ok, es.reshape(-1)[flat_idx], -1)

    fb_val = jnp.asarray(fb_val, jnp.uint32).reshape(())
    fb_rev = jnp.asarray(fb_rev, bool).reshape(())

    def payload(src_state):
        p = jnp.clip(src_state >> 1, 0, t.val_a.shape[0] - 1)
        is_a = (src_state & 1) == 0
        val = jnp.where(src_state < 0, fb_val,
                        jnp.where(is_a, t.val_a[p], t.val_r[p]))
        rev = jnp.where(src_state < 0, fb_rev,
                        jnp.where(is_a, t.rev_a[p], t.rev_r[p]))
        return val, rev

    val, rev = payload(src)
    # tail payload: the last event's in this walk (or the fallback)
    tail_src = jnp.where(scal[1] >= 0, 2 * scal[1] + scal[2], -1)
    tail_val, tail_rev = payload(tail_src.reshape(1))
    return (pos, last, val, rev, n_sel, scal[0], scal[1],
            tail_val[0], tail_rev[0], scal[3])


_compact_jit = jax.jit(_compact_emits, static_argnums=(6,))
_compact_packed_jit = jax.jit(_compact_packed, static_argnums=(6,))


@functools.partial(jax.jit, static_argnums=(2,))
def _walk_jit(t: ScanTables, init5, n_pad: int):
    return _walk_from_tables(t, init5, n_pad)


@jax.jit
def _init5_from_tables(t: ScanTables):
    """Entering state for the first walk of a sequence: the scan's
    initial election (reference SubSampler.cpp:359-365)."""
    return make_init5(t.init_nxt_pos, jnp.where(t.init_nxt_adopt, 0, 1),
                      t.init_sel.astype(_I32))


@functools.partial(jax.jit, static_argnums=(3,))
def _carry_next(scal, t: ScanTables, fb, own: int):
    """Re-base a walk's final state into the NEXT tile's local
    coordinates and resolve the carried payload by value.

    fb: [val(i32 bitcast), rev] fallback payload entering this walk.
    Returns (init5_next, fb_next[2]) — all device-side; chaining tiles
    never syncs the host.
    """
    n_ev, cur_pos, cur_typ, cur_sel, npos, ntyp = (
        scal[0], scal[1], scal[2], scal[3], scal[4], scal[5])
    p = jnp.clip(cur_pos, 0, t.val_a.shape[0] - 1)
    is_a = cur_typ == 0
    val = jnp.where(cur_pos < 0,
                    jax.lax.bitcast_convert_type(fb[0], jnp.uint32),
                    jnp.where(is_a, t.val_a[p], t.val_r[p]))
    rev = jnp.where(cur_pos < 0, fb[1].astype(bool),
                    jnp.where(is_a, t.rev_a[p], t.rev_r[p]))
    init5 = make_init5(jnp.where(npos >= 0, npos - own, -1), ntyp,
                       cur_sel, cur_pos - own, cur_typ)
    fb_next = jnp.stack([
        jax.lax.bitcast_convert_type(val, _I32).reshape(()),
        rev.astype(_I32).reshape(())])
    return init5, fb_next


def _pow2_ge(n: int) -> int:
    p = 16
    while p < n:
        p *= 2
    return p


def _fb_from_tables(t: ScanTables):
    """Fallback payload for a sequence's first walk: the initial
    election's (value, strand)."""
    return jnp.stack([
        jax.lax.bitcast_convert_type(
            t.init_val.astype(jnp.uint32), _I32).reshape(()),
        t.init_rev.astype(_I32).reshape(())])


_fb_jit = jax.jit(_fb_from_tables)


class DeviceChain:
    """Device-side walk + speculative compaction for one walk region.

    Everything is dispatched asynchronously at construction; `compact`
    performs exactly ONE host fetch, re-dispatching only if the
    speculative capacity guess was exceeded.

    For a single-tile sequence, ``DeviceChain(t)`` walks the whole
    table from the scan's initial election. For the tiled path, pass
    the entering state explicitly: ``init5``/``fb`` from the previous
    tile's ``carry`` and ``n_pad`` = the owned region size.
    """

    def __init__(self, t: ScanTables, sel_cap_guess: int = 4096,
                 init5=None, fb=None, n_pad: int | None = None,
                 pack: bool = True):
        if n_pad is None:
            n = int(t.nxt_pos_a.shape[0])
            n_pad = ((n + _BP - 1) // _BP) * _BP
        if init5 is None:
            init5 = _init5_from_tables(t)
        if fb is None:
            fb = _fb_jit(t)
        self._t = t
        self._fb = fb
        self._n_pad = n_pad
        (self.ei, self.el, self.es, self.cnt, self.scal,
         self._n_sel_dev) = _walk_jit(t, init5, n_pad)
        self._cap = _pow2_ge(sel_cap_guess)
        self._packed = None
        if pack:
            self._packed = _compact_packed_jit(
                self.ei, self.el, self.es, self.cnt, self.scal, t,
                self._cap,
                jax.lax.bitcast_convert_type(fb[0], jnp.uint32),
                fb[1] != 0)
            # begin the D2H copy as soon as the compact materializes,
            # behind subsequent dispatches
            self.start_fetch()

    def compact_outs(self, sel_cap: int):
        """Device-resident _compact_emits outputs (dedup path input)."""
        return _compact_jit(
            self.ei, self.el, self.es, self.cnt, self.scal, self._t,
            sel_cap,
            jax.lax.bitcast_convert_type(self._fb[0], jnp.uint32),
            self._fb[1] != 0)

    def carry(self, own: int):
        """(init5, fb) for the next tile's walk (device arrays; no host
        sync)."""
        return _carry_next(self.scal, self._t, self._fb, own)

    def start_fetch(self):
        """Begin the device->host copy of the compact array without
        blocking (overlaps the transfer with later dispatches)."""
        try:
            self._packed.copy_to_host_async()
        except AttributeError:
            pass

    def compact(self):
        """Fetch (sel_pos, sel_last, sel_val, sel_rev, n_ev, last_ev_pos,
        tail_val, tail_rev, tail_sel). Positions are local to this
        walk's coordinates (the tiled caller re-bases). Also sets
        self.n_sel for adaptive capacity guessing by the caller."""
        arr = jax.device_get(self._packed)
        n_sel = int(arr[0])
        if n_sel > self._cap:
            self._cap = _pow2_ge(n_sel)
            self._packed = _compact_packed_jit(
                self.ei, self.el, self.es, self.cnt, self.scal, self._t,
                self._cap,
                jax.lax.bitcast_convert_type(self._fb[0], jnp.uint32),
                self._fb[1] != 0)
            arr = jax.device_get(self._packed)
        self.n_sel = n_sel
        return parse_compact_array(arr, self._cap)


def parse_compact_array(arr: np.ndarray, cap: int):
    """Host-side split of a pack_compact_outs array into the 9-tuple
    compact contract (see DeviceChain.compact)."""
    n_sel = int(arr[0])
    body = arr[8 : 8 + 4 * cap]
    sel_pos = body[:n_sel].astype(np.int64)
    sel_last = body[cap : cap + n_sel].astype(np.int64)
    sel_val = body[2 * cap : 2 * cap + n_sel].view(np.uint32)
    sel_rev = body[3 * cap : 3 * cap + n_sel] != 0
    return (sel_pos, sel_last, sel_val, sel_rev, int(arr[1]),
            int(arr[2]), int(np.int64(arr[3]) & 0xFFFFFFFF),
            bool(arr[4]), bool(arr[5]))
