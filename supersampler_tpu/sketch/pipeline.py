"""Sketch-construction pipeline.

The per-position hash/election math runs on device (ops/minimizer.py);
the event chain (super-k-mer boundaries) is extracted from the device's
successor tables; the tiny tail of selected super-k-mers is assembled
and serialized on host with the exact reference semantics (reused from
the oracle implementation, which is the tested scalar spec).

Equivalent call stack in the reference: Subsampler::parse_fasta_test
(SubSampler.cpp:306-510).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


import jax

from supersampler_tpu.backend import engine
from supersampler_tpu.ops import u64 as U
from supersampler_tpu.ops.dedup import (dedup_chain_packed,
                                        field_dedup_packed,
                                        merge_unique_host,
                                        parse_dedup_array,
                                        parse_field_dedup_array)
from supersampler_tpu.ops.field import (field_carry, field_entry_init,
                                        parse_field_array, resolve_field,
                                        scan_field_2d_packed)
from supersampler_tpu.ops.minimizer import (pack_ref_2bit,
                                            scan_tables_2d_packed)
from supersampler_tpu.ops.walker import DeviceChain, _pow2_ge
from supersampler_tpu.oracle.subsampler import OracleSubsampler

# Tiled-scan geometry: sequences longer than one tile stream through
# fixed (OWN + EXTRA)-sized scans whose walks chain via a device-side
# carry — O(tile) memory for any length, like the reference's O(1)-state
# streaming loop (reference SubSampler.cpp:367-440).
_TILE_OWN = 1 << 22       # loop positions owned per tile (4 Mbp)
_TILE_EXTRA = 512         # lookahead suffix; >= margin for k <= 63
_TILE_P = _TILE_OWN + _TILE_EXTRA

_PAD_BUCKETS = [1 << b for b in range(10, 23)]

device_scan_2d_packed = jax.jit(scan_tables_2d_packed,
                                static_argnums=(1, 2, 3, 6))
device_scan_field_packed = jax.jit(scan_field_2d_packed,
                                   static_argnums=(1, 2, 3, 5, 6))


@jax.jit
def _stack_arrs(arrs):
    """Stack same-shaped compact arrays so one D2H transfer fetches a
    whole record batch."""
    return jnp.stack(arrs)


def _scan_chain_packed(packed, k: int, m: int, P: int, length, thr_hi,
                       thr_lo, sel_cap_guess: int = 4096) -> DeviceChain:
    """2D scan + chain walk + speculative compaction — three
    asynchronous device dispatches, zero host syncs (ops/walker.py).

    Kept as separate jit units: fusing them into one XLA program
    multiplies CPU-backend compile time ~10x for a small dispatch win,
    and the intermediate ScanTables never leave the device either way."""
    t = device_scan_2d_packed(packed, k, m, P, length,
                              U.U64(thr_hi, thr_lo))
    return DeviceChain(t, sel_cap_guess=sel_cap_guess)


def padded_size(n: int, margin: int = 128) -> int:
    """Power-of-two padding (single-tile path) with room for the 2D
    layout's halo (k + W lookahead columns wrap across rows). Sequences
    that don't fit one tile go through TiledDeviceChain instead."""
    for b in _PAD_BUCKETS:
        if n + margin <= b:
            return b
    raise ValueError(f"not a single-tile sequence: {n}")


class DedupDeviceChain:
    """Walk + on-device k-mer dedup for one region; a single fetch
    carries the compact boundaries AND the unique k-mers (ops/dedup.py).

    packed_ext: 2-bit packed codes of [region_start - 128, region_start
    + P); tables were scanned from the non-halo'd slice.
    length: local sequence length, or -1 for a non-final tile (no tail
    flush here).
    """

    def __init__(self, tables, packed_ext, P_ext: int, k: int, m: int,
                 length: int, sel_cap_guess: int = 4096,
                 kmer_cap_guess: int = 8192, init5=None, fb=None,
                 n_pad: int | None = None):
        self._dc = DeviceChain(tables, sel_cap_guess=sel_cap_guess,
                               init5=init5, fb=fb, n_pad=n_pad,
                               pack=False)
        self._k, self._m = k, m
        self._packed_ext = packed_ext
        self._P_ext = P_ext
        self._len = length
        self._cap = _pow2_ge(sel_cap_guess)
        self._K = _pow2_ge(kmer_cap_guess)
        self._dispatch()

    def _dispatch(self):
        outs = self._dc.compact_outs(self._cap)
        self._arr = dedup_chain_packed(
            outs, self._dc.scal, self._packed_ext, jnp.int32(self._len),
            self._k, self._m, self._P_ext, self._K)
        self.start_fetch()

    def carry(self, own: int):
        return self._dc.carry(own)

    def start_fetch(self):
        try:
            self._arr.copy_to_host_async()
        except AttributeError:
            pass

    def compact(self):
        arr = jax.device_get(self._arr)
        n_sel = int(arr[0])
        n_kmers = int(arr[8 + 4 * self._cap])
        if n_sel > self._cap or n_kmers > self._K:
            self._cap = max(self._cap, _pow2_ge(max(n_sel, 1)))
            # a truncated span list underreports n_kmers; upper-bound by
            # the span capacity times the max super-k-mer k-mer count
            self._K = max(self._K, _pow2_ge(max(
                n_kmers, (n_sel + 1) * (self._k - self._m + 1))))
            self._dispatch()
            arr = jax.device_get(self._arr)
        comp, self.n_sel, self.n_kmers, self.uniques = parse_dedup_array(
            arr, self._cap, self._K)
        return comp


class TiledDeviceChain:
    """Scan + walk of one long sequence as a pipeline of fixed tiles.

    Tile t owns loop positions [t*OWN, (t+1)*OWN) and scans
    OWN + EXTRA positions (the suffix covers every lookahead a
    successor-table entry of an owned position can make). Walks chain
    through a device-side carry — the next-event pointer and the open
    super-k-mer's payload re-based to the next tile's coordinates
    (ops/walker.py carry/make_init5) — so the host never syncs between
    tiles; compact fetches stream back `window` tiles behind the
    dispatch front, bounding device memory.
    """

    def __init__(self, packed_slab: np.ndarray, n_tiles: int, k: int,
                 m: int, length: int, threshold: int,
                 sel_cap_guess: int = 4096, select_all: bool = False,
                 window: int = 3, own: int = _TILE_OWN,
                 extra: int = _TILE_EXTRA, dedup: bool = False,
                 kmer_cap_guess: int = 8192):
        # packed_slab is 128-halo'd: byte 32 holds position 0 (see
        # TpuSubsampler._launch_scan)
        self._packed_slab = packed_slab
        self._n_tiles = n_tiles
        self._k, self._m = k, m
        self._L = length
        self._own = own           # must be a multiple of the walker _BP
        self._tile_p = own + extra
        self._thr = (jnp.uint32(threshold >> 32),
                     jnp.uint32(threshold & 0xFFFFFFFF))
        self._guess = sel_cap_guess
        self._select_all = select_all
        self._window = window
        self._dedup = dedup
        self._kguess = kmer_cap_guess
        self._parts = []          # fetched per-tile compact tuples
        self._pending = []        # dispatched, unfetched DeviceChains
        self._next_tile = 0
        self._carry = None        # (init5, fb) device arrays
        self.uniques_list = [] if dedup else None
        # prime the pipeline without blocking: dispatch `window` tiles
        for _ in range(min(window, n_tiles)):
            self._dispatch_one()

    def _dispatch_one(self):
        t = self._next_tile
        self._next_tile += 1
        own = self._own
        b0 = (t * own) >> 2
        packed_ext = jnp.asarray(
            self._packed_slab[b0 : b0 + ((self._tile_p + 128) >> 2)])
        packed = packed_ext[32:]
        tables = device_scan_2d_packed(
            packed, self._k, self._m, self._tile_p,
            jnp.int32(self._L - t * own), U.U64(*self._thr))
        guess = own if self._select_all else self._guess
        init5, fb = self._carry if self._carry is not None else (None,
                                                                 None)
        if self._dedup:
            is_last = t == self._n_tiles - 1
            dc = DedupDeviceChain(
                tables, packed_ext, self._tile_p + 128, self._k,
                self._m, (self._L - t * own) if is_last else -1,
                sel_cap_guess=guess, kmer_cap_guess=self._kguess,
                init5=init5, fb=fb, n_pad=own)
        else:
            dc = DeviceChain(tables, sel_cap_guess=guess, init5=init5,
                             fb=fb, n_pad=own)
        self._carry = dc.carry(own)
        dc.start_fetch()
        self._pending.append((t, dc))

    def _fetch_one(self):
        t, dc = self._pending.pop(0)
        comp = dc.compact()
        if not self._select_all:
            self._guess = max(4096, 2 * dc.n_sel)
        if self._dedup:
            self._kguess = max(8192, 2 * dc.n_kmers)
            self.uniques_list.append(dc.uniques)
        self._parts.append((t, comp))

    def compact(self):
        """Drive the tile pipeline to completion and merge the per-tile
        compacts into one sequence-level tuple (same contract as
        DeviceChain.compact, with global positions)."""
        while self._next_tile < self._n_tiles:
            if len(self._pending) >= self._window:
                self._fetch_one()
            self._dispatch_one()
        while self._pending:
            self._fetch_one()

        pos_l, last_l, val_l, rev_l = [], [], [], []
        n_ev = 0
        tail = (0, False, False)
        last_ev_pos = -1
        for t, comp in self._parts:
            (sp, sl, sv, sr, ev_t, last_pos_t, tv, tr, ts) = comp
            base = t * self._own
            pos_l.append(sp + base)
            last_l.append(sl + base)
            val_l.append(sv)
            rev_l.append(sr)
            n_ev += ev_t
            if t == self._n_tiles - 1:
                tail = (tv, tr, ts)
                last_ev_pos = last_pos_t + base
        self.n_sel = sum(a.size for a in pos_l)
        return (np.concatenate(pos_l), np.concatenate(last_l),
                np.concatenate(val_l), np.concatenate(rev_l), n_ev,
                last_ev_pos, tail[0], tail[1], tail[2])


class FieldChain:
    """Sync-field scan chain for one sequence — single tile or tiled,
    with optional device dedup. The walker-free default engine
    (ops/field.py); on a resolution overflow (pathological content,
    e.g. multi-kilobase homopolymer runs defeating the sync theorem's
    pass budget) ONLY the failing tile re-runs through the legacy
    successor-table + serial-walker path (exact on everything) — the
    machine state converts walker<->field at the tile boundary
    (ops/field.py field_entry_to_walker_init /
    walker_exit_to_field_entry), so healthy tiles never pay the
    serial walker.
    """

    def __init__(self, packed_slab: np.ndarray, n_tiles: int, k: int,
                 m: int, length: int, threshold: int, own: int,
                 extra: int, sel_cap_guess: int = 4096,
                 kmer_cap_guess: int = 8192, select_all: bool = False,
                 dedup: bool = False, window: int = 3):
        self._slab = packed_slab          # 128-halo'd 2-bit codes
        self._n_tiles = n_tiles
        self._k, self._m = k, m
        self._L = length
        self._thrv = threshold
        self._thr = (jnp.uint32(threshold >> 32),
                     jnp.uint32(threshold & 0xFFFFFFFF))
        self._own = own
        self._extra = extra
        self._tile_p = own + extra
        self._guess = sel_cap_guess
        self._kguess = kmer_cap_guess
        self._select_all = select_all
        self._dedup = dedup
        self._window = window
        self._parts = []
        self._pending = []
        self._next_tile = 0
        self._entry = None
        self.fallback_tiles = []   # tiles that took the walker path
        self.uniques_list = [] if dedup else None
        # fused single-tile dispatch on the GPU: scan+entry+resolve as
        # one jit program instead of three. The CPU keeps split
        # dispatches — fusing multiplies CPU-backend compile time for
        # no dispatch win.
        self._fused = (n_tiles == 1 and not dedup
                       and engine() == "gpu")
        for _ in range(min(window, n_tiles)):
            self._dispatch_one()

    def _dispatch_one(self):
        t = self._next_tile
        self._next_tile += 1
        k, m = self._k, self._m
        own, P_t = self._own, self._tile_p
        if self._fused:
            from supersampler_tpu.ops.field import scan_resolve_single

            cap = _pow2_ge(own if self._select_all else self._guess)
            slab_dev = jnp.asarray(self._slab[: (P_t + 128) >> 2])
            arr = scan_resolve_single(slab_dev, k, m, P_t, cap,
                                      jnp.int32(self._L), *self._thr)
            try:
                arr.copy_to_host_async()
            except AttributeError:
                pass
            self._pending.append((0, None, None, slab_dev, cap, 0, arr))
            return
        b0 = (t * own) >> 2
        ext = jnp.asarray(self._slab[b0 : b0 + ((P_t + 128) >> 2)])
        last = t == self._n_tiles - 1
        len_local = self._L - t * own
        # non-final tiles cap last_i at own-1 (the carry handoff point)
        length_t = len_local if last else (own + k)
        ft = device_scan_field_packed(ext[32:], k, m, P_t,
                                      jnp.int32(length_t), t == 0)
        entry = (field_entry_init(ft, *self._thr) if t == 0
                 else self._entry)
        cap = _pow2_ge(own if self._select_all else self._guess)
        arr = resolve_field(ft, k, m, cap, entry, *self._thr)
        if t < self._n_tiles - 1:   # the last tile's carry is never read
            self._entry = field_carry(arr, own)
        K = 0
        if self._dedup:
            K = _pow2_ge(own if self._select_all else self._kguess)
            arr = field_dedup_packed(
                arr, cap, ext, jnp.int32(len_local if last else -1),
                k, m, P_t + 128, K)
        try:
            arr.copy_to_host_async()
        except AttributeError:
            pass
        self._pending.append((t, ft, entry, ext, cap, K, arr))

    def _tile_fallback(self, t, ft, entry, ext, cap):
        """Exact walker re-run of ONE failed tile; predecessors' field
        results stand and the exit state re-enters the field path at
        tile t+1 (tiles already dispatched past t carried a garbage
        entry and are discarded/redispatched)."""
        from supersampler_tpu.ops.field import (
            field_entry_to_walker_init, walker_exit_to_field_entry)

        self._pending.clear()
        self._next_tile = t + 1
        self.fallback_tiles.append(t)
        k, m = self._k, self._m
        own = self._own
        last = t == self._n_tiles - 1
        tables = device_scan_2d_packed(
            ext[32:], k, m, self._tile_p,
            jnp.int32(self._L - t * own), U.U64(*self._thr))
        init5, fb = field_entry_to_walker_init(ft, entry)
        guess = own if self._select_all else max(cap, 4096)
        if self._dedup:
            dc = DedupDeviceChain(
                tables, ext, self._tile_p + 128, k, m,
                (self._L - t * own) if last else -1,
                sel_cap_guess=guess, kmer_cap_guess=self._kguess,
                init5=init5, fb=fb, n_pad=own)
            scal = dc._dc.scal
        else:
            dc = DeviceChain(tables, sel_cap_guess=guess, init5=init5,
                             fb=fb, n_pad=own)
            scal = dc.scal
        if not last:
            self._entry = walker_exit_to_field_entry(
                ft, scal, entry, k, m, own, *self._thr)
        comp = dc.compact()
        if self._dedup:
            self.uniques_list.append(dc.uniques)
            self._kguess = max(8192, 2 * dc.n_kmers)
        if not self._select_all:
            self._guess = max(4096, 2 * dc.n_sel)
        self._parts.append((t, comp))

    def _fetch_one(self):
        t, ft, entry, ext, cap, K, arr = self._pending.pop(0)
        a = jax.device_get(arr)
        if int(a[0]) != 0:
            if ft is None:
                # fused single-tile dispatch kept no tables: recompute
                # them (cheap next to the walker it feeds)
                from supersampler_tpu.ops.field import field_entry_init

                ft = device_scan_field_packed(
                    ext[32:], self._k, self._m, self._tile_p,
                    jnp.int32(self._L), True)
                entry = field_entry_init(ft, *self._thr)
            self._tile_fallback(t, ft, entry, ext, cap)
            return
        n_sel = int(a[1])
        n_kmers = int(a[12 + 4 * cap]) if self._dedup else 0
        while n_sel > cap or (self._dedup and n_kmers > K):
            cap = max(_pow2_ge(max(n_sel, 1)), cap)
            if ft is None:     # fused path: re-run the one-shot program
                from supersampler_tpu.ops.field import scan_resolve_single

                arr = scan_resolve_single(ext, self._k, self._m,
                                          self._tile_p, cap,
                                          jnp.int32(self._L), *self._thr)
                a = jax.device_get(arr)
                n_sel = int(a[1])
                continue
            arr = resolve_field(ft, self._k, self._m, cap, entry,
                                *self._thr)
            if self._dedup:
                K = max(K, _pow2_ge(max(
                    n_kmers,
                    (n_sel + 1) * (self._k - self._m + 1))))
                last = t == self._n_tiles - 1
                arr = field_dedup_packed(
                    arr, cap, ext,
                    jnp.int32((self._L - t * self._own) if last else -1),
                    self._k, self._m, self._tile_p + 128, K)
            a = jax.device_get(arr)
            n_sel = int(a[1])
            n_kmers = int(a[12 + 4 * cap]) if self._dedup else 0
        if self._dedup:
            _st, comp, _ns, n_kmers, uniques = parse_field_dedup_array(
                a, cap, K)
            self.uniques_list.append(uniques)
            self._kguess = max(8192, 2 * n_kmers)
            self.n_kmers = n_kmers
        else:
            _st, comp, _ns = parse_field_array(a, cap)
        if not self._select_all:
            self._guess = max(4096, 2 * n_sel)
        self._parts.append((t, comp))

    def compact(self):
        # single driver loop: a tile fallback during the drain phase
        # rewinds _next_tile (its successors were dispatched with a
        # garbage entry), so dispatching must stay possible until the
        # very end
        while self._next_tile < self._n_tiles or self._pending:
            if (len(self._pending) >= self._window
                    or self._next_tile >= self._n_tiles):
                self._fetch_one()
            else:
                self._dispatch_one()
        pos_l, last_l, val_l, rev_l = [], [], [], []
        n_ev = 0
        tail = (0, False, False)
        last_ev_pos = -1
        for t, comp in self._parts:
            (sp, sl, sv, sr, ev_t, last_pos_t, tv, tr, ts) = comp
            base = t * self._own
            pos_l.append(sp + base)
            last_l.append(sl + base)
            val_l.append(sv)
            rev_l.append(sr)
            n_ev += ev_t
            if t == self._n_tiles - 1:
                tail = (tv, tr, ts)
                last_ev_pos = last_pos_t + base
        self.n_sel = sum(a.size for a in pos_l)
        return (np.concatenate(pos_l), np.concatenate(last_l),
                np.concatenate(val_l), np.concatenate(rev_l), n_ev,
                last_ev_pos, tail[0], tail[1], tail[2])


class TpuSubsampler(OracleSubsampler):
    """Sketch builder whose streaming scan runs on the device.

    Inherits bucket intake, greedy reconstruction, serialization and
    stats from the scalar spec; only scan_sequence is replaced.
    """

    _sel_cap_guess = 4096
    _kmer_cap_guess = 8192
    # short-record batching (sketch_file): records whose padded bucket
    # is <= _SHORT_MAX positions resolve in per-bucket batches of up
    # to _SHORT_BATCH_MAX records via ONE fused device program + ONE
    # fetch; _batch_sel_rate is the adaptive selected-events-per-
    # position estimate that sizes each batch's capacity.
    _SHORT_MAX = 1 << 16
    _SHORT_BATCH_MAX = 4096
    _batch_sel_rate = 0.002
    # tile geometry (class-level so tests can shrink it to exercise the
    # multi-tile carry path on small inputs)
    _tile_own = _TILE_OWN
    _tile_extra = _TILE_EXTRA
    # device-side dedup (ops/dedup.py): None = auto — on when the FHS
    # rate makes selected k-mers dense enough that the reference's
    # per-occurrence host intake (SubSampler.cpp:258-301) would
    # dominate; off for sparse selection where the extra device pass
    # costs more than it saves.
    device_dedup = None
    # scan engine: "field" = sync-field resolution (ops/field.py) —
    # walker-free, exact, and the default. "legacy" = successor
    # tables + chain walk (ops/walker.py) — kept as the
    # exact fallback (FieldChain re-runs through it automatically when
    # the sync theorem's pass budget overflows, e.g. megabase
    # homopolymers). Both engines are golden-tested.
    scan_engine = "field"

    # native (C) host finisher: k-mer store + greedy reconstruction +
    # serialization in csrc/spsp_finish.c — the host tail of every
    # sketch. None = auto (on when the library builds
    # and the device-dedup path, which owns the Python store, is off).
    native_finisher = None

    def _dedup_on(self) -> bool:
        if self.device_dedup is not None:
            return bool(self.device_dedup)
        # auto: the native C finisher ingests spans faster than the
        # device dedup's host-side unique merge at every FHS rate, so
        # device dedup is the fallback for toolchain-less environments.
        from supersampler_tpu.native import NativeFinisher

        if NativeFinisher.available():
            return False
        return self.s <= 64

    def _nf(self):
        obj = getattr(self, "_nf_obj", None)
        if obj is not None:
            return obj
        if getattr(self, "_nf_checked", False):
            return None
        self._nf_checked = True
        use = self.native_finisher
        if use is None:
            from supersampler_tpu.native import NativeFinisher

            use = NativeFinisher.available() and not self._dedup_on()
        if not use:
            self._nf_obj = None
            return None
        from supersampler_tpu.native import NativeFinisher

        self._nf_obj = NativeFinisher(self.k, self.m, self.abundance)
        return self._nf_obj

    def _launch_scan(self, ref: bytes, codes=None):
        """Asynchronously dispatch the device scan + chain walk for one
        sequence (jax dispatch is non-blocking). Sequences that fit one
        tile take the single-dispatch path; longer ones stream through
        TiledDeviceChain with O(tile) memory.

        codes: optional precomputed 2-bit code array for ref (from
        native.clean_codes_native) — skips the re-translate inside
        pack_ref_2bit."""
        k, m = self.k, self.m
        L = len(ref)
        if isinstance(ref, str):
            ref = ref.encode()

        def pack(padded, halo=0):
            if codes is not None:
                from supersampler_tpu.native import pack_halo_native

                p = pack_halo_native(codes, padded, halo)
                if p is not None:
                    return p
            return pack_ref_2bit(ref, padded, halo)
        margin = 2 * (2 * k - m + 2) + 128
        thr = self.threshold
        dedup = self._dedup_on()
        if self.scan_engine == "field" and L + margin > 1024:
            if L + margin <= self._tile_own:
                own = max(padded_size(L, margin), 2048)
                n_tiles = 1
            else:
                own = self._tile_own
                n_tiles = max(1, -(-(L - k) // own))
            slab = pack(n_tiles * own + self._tile_extra, halo=128)
            sel_guess = (own if self.s <= 1 else self._sel_cap_guess)
            return FieldChain(
                slab, n_tiles, k, m, L, thr, own,
                self._tile_extra, sel_cap_guess=sel_guess,
                kmer_cap_guess=self._kmer_cap_guess,
                select_all=self.s <= 1, dedup=dedup)
        if L + margin <= self._tile_own:
            P = padded_size(L, margin)
            if self.s <= 1:
                # select-all: every boundary selected; skip speculation
                guess = P
            else:
                guess = self._sel_cap_guess
            if not dedup:
                return _scan_chain_packed(
                    jnp.asarray(pack(P)), k, m, P, jnp.int32(L),
                    jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF),
                    sel_cap_guess=guess)
            packed_ext = jnp.asarray(pack(P, halo=128))
            tables = device_scan_2d_packed(
                packed_ext[32:], k, m, P, jnp.int32(L),
                U.U64(jnp.uint32(thr >> 32),
                      jnp.uint32(thr & 0xFFFFFFFF)))
            kguess = (P if self.s <= 1 else self._kmer_cap_guess)
            return DedupDeviceChain(
                tables, packed_ext, P + 128, k, m, L,
                sel_cap_guess=guess, kmer_cap_guess=kguess)
        own = self._tile_own
        n_tiles = max(1, -(-(L - k) // own))
        slab = pack(n_tiles * own + self._tile_extra, halo=128)
        return TiledDeviceChain(
            slab, n_tiles, k, m, L, thr,
            sel_cap_guess=self._sel_cap_guess,
            select_all=self.s <= 1, own=own, extra=self._tile_extra,
            dedup=dedup,
            kmer_cap_guess=(own if self.s <= 1
                            else self._kmer_cap_guess))

    @staticmethod
    def _uniques_of(dc):
        ul = getattr(dc, "uniques_list", None)
        if ul is not None:
            return ul
        u = getattr(dc, "uniques", None)
        return [u] if u is not None else None

    def _finish_scan(self, ref: str, dc) -> None:
        comp = dc.compact()
        self._assemble_compact(ref, *comp,
                               uniques_list=self._uniques_of(dc))
        # adapt the speculative capacities to this input
        self._sel_cap_guess = max(4096, 2 * dc.n_sel)
        if getattr(dc, "n_kmers", None) is not None:
            self._kmer_cap_guess = max(8192, 2 * dc.n_kmers)

    def scan_sequence(self, ref: str) -> None:
        self._finish_scan(ref, self._launch_scan(ref))

    def _plan_geometry(self, n_raw: int):
        """Slab geometry (own, n_tiles) for a record whose CLEANED
        length cannot exceed n_raw (cleaning only strips bytes); None
        when the record must take the legacy (non-field or tiny)
        launch path. Planning from the RAW span length lets the prep
        stage clean + pack in one C pass without knowing the cleaned
        length up front; a record that cleans into fewer tiles is
        sliced down after the fact (the slab is a contiguous prefix)."""
        k, m = self.k, self.m
        margin = 2 * (2 * k - m + 2) + 128
        if self.scan_engine != "field" or n_raw + margin <= 1024:
            return None
        if n_raw + margin <= self._tile_own:
            return max(padded_size(n_raw, margin), 2048), 1
        own = self._tile_own
        return own, max(1, -(-(n_raw - k) // own))

    def sketch_file(self, input_path: str):
        """Chunked, batch-granular record pipeline over one FASTA file
        — a one-member shared run (see _SharedSketchRun / sketch_fof,
        which batch device work ACROSS files in fof mode)."""
        return sketch_fof([(self, input_path)])[0]

    def _span_counters_run(self, lens, heads, pos, last, offs):
        """Vectorized stats bookkeeping for a RUN of batched records
        (the per-record scalar loop of _span_counters, computed across
        the whole run's record-major event arrays; reference
        accounting SubSampler.cpp:401-454 + 633-665)."""
        k, m = self.k, self.m
        n_rec = len(lens)
        n_ev_r = heads[:, 2].astype(np.int64)
        live = lens >= k
        self.total_kmer_number += int(np.sum(lens[live] - k + 1))
        self.total_superkmer_number += int(
            np.sum(n_ev_r[live] + 1))
        n = pos.size
        if n:
            counts = (offs[1:] - offs[:-1]).astype(np.int64)
            first_idx = offs[:-1][counts > 0]
            is_first = np.zeros(n, bool)
            is_first[first_idx] = True
            prev_pos = np.empty(n, np.int64)
            prev_pos[0] = 0
            prev_pos[1:] = pos[:-1]
            pos_end_prev = np.where(is_first, 0, prev_pos + k - 1)
            c1 = last + m - 2 > pos_end_prev
            contrib = np.where(
                c1,
                np.where(pos_end_prev > 0, -(m - 1), 0)
                + (pos + k - last) - (k - m),
                pos + k - (pos_end_prev + 1))
            self.nb_mmer_selected += int(contrib.sum())
            slens = pos + k - last
            self.selected_superkmer_number += n
            self.selected_kmer_number += int((slens - k + 1).sum())
            self.count_maximal_skmer += int(
                (slens == 2 * k - m).sum())
        tail_sel = heads[:, 6] != 0
        if tail_sel.any():
            t_last = np.where(heads[:, 2] > 0, heads[:, 3] + 1, 0)
            tlen = (lens - t_last)[tail_sel]
            cnt = int(tail_sel.sum())
            self.nb_mmer_selected -= (m - 1) * cnt
            self.selected_superkmer_number += cnt
            self.selected_kmer_number += int((tlen - k + 1).sum())
            self.count_maximal_skmer += int(
                (tlen == 2 * k - m).sum())

    def _sketch_file_compat(self, input_path: str):
        """Like OracleSubsampler.sketch_file but keeps a small window of
        sequences in flight on the device: the scan of record n+1..n+W
        overlaps with the host assembly of record n, and the compaction
        fetch runs on a background thread so it overlaps host work too.
        The toolchain-less fallback for sketch_file (no native lib, or
        the device-dedup path which owns the Python store)."""
        import collections
        import concurrent.futures
        import os
        import sys

        from supersampler_tpu.io.fasta import clean_dna, iter_fasta_raw
        from supersampler_tpu.native import clean_codes_native
        from supersampler_tpu.core.scalar import MASK64
        from supersampler_tpu.utils.profiling import device_trace, phase

        k = self.k
        if not os.path.exists(input_path):
            log = self.log or sys.stdout
            print("Problem with file opening", file=log)
            print(f"Can't open file: {input_path}", file=log)
            return None
        window = 4
        pending = collections.deque()
        # three-way pipeline: the launcher thread packs + dispatches
        # record n+1 while the fetch thread drains record n-w's compact
        # and the main thread assembles record n-w (numpy/zlib release
        # the GIL, so the stages genuinely overlap)
        with device_trace("sketch_file"), \
                concurrent.futures.ThreadPoolExecutor(1) as fetcher, \
                concurrent.futures.ThreadPoolExecutor(1) as launcher:
            # cleaning (the parse hot spot) + packing + dispatch run on
            # the launcher thread; the record-length filter depends on
            # the CLEANED length, so it lives there too
            def launch(raw):
                with phase("launch_scan"):
                    cc = clean_codes_native(raw)
                    if cc is None:
                        ref, codes = clean_dna(raw), None
                    else:
                        ref, codes = cc
                    if len(ref) < k:
                        return None
                    self.read_kmer += len(ref) - k + 1
                    return ref, self._launch_scan(ref, codes=codes)

            def launch_then_fetch(lfut):
                with phase("device+fetch"):
                    r = lfut.result()
                    if r is None:
                        return None
                    return r[0], self._fetch(r[1])

            def drain(fut):
                r = fut.result()
                if r is None:
                    return
                with phase("assemble"):
                    self._assemble_from(r[0], r[1])

            with phase("parse"):
                raws = list(iter_fasta_raw(input_path))
            for raw in raws:
                if len(pending) >= window:
                    drain(pending.popleft())
                pending.append(fetcher.submit(
                    launch_then_fetch, launcher.submit(launch, raw)))
            while pending:
                drain(pending.popleft())
        self.nb_mmer_selected = (self.nb_mmer_selected
                                 - (self.m - 1)) & MASK64
        with phase("serialize"):
            return self.serialize()

    @staticmethod
    def _fetch(dc):
        return dc.compact(), dc.n_sel, TpuSubsampler._uniques_of(dc), \
            getattr(dc, "n_kmers", None)

    def _assemble_from(self, ref: str, fetched) -> None:
        compact, n_sel, uniques_list, n_kmers = fetched
        self._assemble_compact(ref, *compact, uniques_list=uniques_list)
        self._sel_cap_guess = max(4096, 2 * n_sel)
        if n_kmers is not None:
            self._kmer_cap_guess = max(8192, 2 * n_kmers)

    def _assemble_compact(self, ref, sel_pos, sel_last, sel_val, sel_rev,
                          n_ev, last_ev_pos, tail_val, tail_rev,
                          tail_sel, uniques_list=None):
        """Replay the boundary loop (SubSampler.cpp:401-454) from the
        device-compacted selected boundaries.

        The aggregate counters telescope: each event n contributes
        pos[n]-pos[n-1] k-mers and the tail flush always fires (events
        are confined to i <= L-k-1), so the per-sequence totals are
        exactly L-k+1 k-mers and n_ev+1 super-k-mers.

        With uniques_list (device-dedup path) the per-span intake is
        already done on device; only the counters run here, vectorized,
        and the unique k-mers bulk-merge into the buckets.
        """
        k, m = self.k, self.m
        L = len(ref)
        self.total_kmer_number += L - k + 1
        self.total_superkmer_number += n_ev + 1
        if uniques_list is not None:
            self._assemble_dedup(L, sel_pos, sel_last, n_ev, last_ev_pos,
                                 tail_sel, uniques_list)
            return
        nf = self._nf()
        if nf is not None:
            self._span_counters(L, sel_pos, sel_last, n_ev, last_ev_pos,
                                tail_sel)
            if isinstance(ref, str):
                ref = ref.encode()
            pos = np.asarray(sel_pos, np.int64)
            last = np.asarray(sel_last, np.int64)
            val = np.asarray(sel_val, np.uint32)
            rev = np.asarray(sel_rev, np.uint8)
            if tail_sel:
                t_last = last_ev_pos + 1 if n_ev else 0
                pos = np.append(pos, L - k)
                last = np.append(last, t_last)
                val = np.append(val, np.uint32(tail_val))
                rev = np.append(rev, np.uint8(tail_rev))
            nf.add_spans(ref, pos, last, val, rev)
            return
        pos_end = 0
        for j in range(len(sel_pos)):
            i = int(sel_pos[j])
            last_position = int(sel_last[j])
            if last_position + m - 2 > pos_end:
                if pos_end > 0:
                    self.nb_mmer_selected -= m - 1
                self.nb_mmer_selected += i + k - last_position
                self.nb_mmer_selected -= k - m
            else:
                self.nb_mmer_selected += i + k - (pos_end + 1)
            self.handle_superkmer(
                ref[last_position : i + k], int(sel_val[j]),
                bool(sel_rev[j]))
            pos_end = i + k - 1
        # tail flush (SubSampler.cpp:441-454); L - last_position > k-1
        # always holds since last_ev_pos <= L-k-1
        last_position = last_ev_pos + 1 if n_ev else 0
        if tail_sel:
            self.nb_mmer_selected -= m - 1
            self.handle_superkmer(ref[last_position:], int(tail_val),
                                  bool(tail_rev))

    def _span_counters(self, L, sel_pos, sel_last, n_ev, last_ev_pos,
                       tail_sel):
        """Vectorized equivalent of the scalar assembly loop's counter
        bookkeeping + handle_superkmer's own stats (used by the
        device-dedup and native-finisher paths)."""
        k, m = self.k, self.m
        n = len(sel_pos)
        if n:
            pos_end_prev = np.concatenate(
                [[0], np.asarray(sel_pos[:-1]) + k - 1])
            i_arr = np.asarray(sel_pos)
            last_arr = np.asarray(sel_last)
            c1 = last_arr + m - 2 > pos_end_prev
            contrib = np.where(
                c1,
                np.where(pos_end_prev > 0, -(m - 1), 0)
                + (i_arr + k - last_arr) - (k - m),
                i_arr + k - (pos_end_prev + 1))
            self.nb_mmer_selected += int(contrib.sum())
            lens = i_arr + k - last_arr
            self.selected_superkmer_number += n
            self.selected_kmer_number += int((lens - k + 1).sum())
            self.count_maximal_skmer += int((lens == 2 * k - m).sum())
        if tail_sel:
            self.nb_mmer_selected -= m - 1
            last_position = last_ev_pos + 1 if n_ev else 0
            tlen = L - last_position
            self.selected_superkmer_number += 1
            self.selected_kmer_number += tlen - k + 1
            if tlen == 2 * k - m:
                self.count_maximal_skmer += 1

    def _assemble_dedup(self, L, sel_pos, sel_last, n_ev, last_ev_pos,
                        tail_sel, uniques_list):
        """Counter bookkeeping + bucket merge for the device-dedup
        path."""
        self._span_counters(L, sel_pos, sel_last, n_ev, last_ev_pos,
                            tail_sel)
        for uniques in uniques_list:
            merge_unique_host(self, uniques, self.k)

    def serialize(self) -> bytes:
        nf = getattr(self, "_nf_obj", None)
        if nf is None:
            return super().serialize()
        from supersampler_tpu.core.scalar import format_double

        header = "{} {} {} {}\n".format(
            self.k - 1 + self.max_superkmer_size,
            self.m, self.selected_kmer_number,
            format_double(self.s)).encode()
        payload, c = nf.serialize()
        self.seen_kmers_at_reconstruction += int(c[0])
        self.seen_superkmers_at_reconstruction += int(c[1])
        self.seen_max_superkmers_at_reconstruction += int(c[2])
        self.seen_unique_kmers_at_reconstruction += int(c[3])
        self.total_kmer_number_at_reconstruction += int(c[4])
        self.actual_minimizer_number = int(c[5])
        return header + payload

    def _assemble(self, ref, pos, val, rev, sel, init):
        """Replay the boundary bookkeeping of the reference loop
        (SubSampler.cpp:401-454) over the event list.

        Aggregate stats are vectorized; Python only touches the
        *selected* boundaries (the FHS-sampled tail).
        """
        k, m = self.k, self.m
        L = len(ref)
        n_ev = len(pos)
        # boundary n closes the super-k-mer started after boundary n-1,
        # carrying the PREVIOUS event's (or init's) payload
        last_positions = np.empty(n_ev, dtype=np.int64)
        prev_val = np.empty(n_ev, dtype=np.uint32)
        prev_rev = np.empty(n_ev, dtype=bool)
        prev_sel = np.empty(n_ev, dtype=bool)
        if n_ev:
            last_positions[0] = 0
            last_positions[1:] = pos[:-1] + 1
            prev_val[0], prev_rev[0], prev_sel[0] = init
            prev_val[1:] = val[:-1]
            prev_rev[1:] = rev[:-1]
            prev_sel[1:] = sel[:-1]
        self.total_kmer_number += int(np.sum(pos - last_positions + 1))
        self.total_superkmer_number += n_ev
        # selected boundaries: handle_superkmer + density bookkeeping
        # (pos_end is sequential but only across selected boundaries)
        pos_end = 0
        for n in np.nonzero(prev_sel)[0]:
            i = int(pos[n])
            last_position = int(last_positions[n])
            if last_position + m - 2 > pos_end:
                if pos_end > 0:
                    self.nb_mmer_selected -= m - 1
                self.nb_mmer_selected += i + k - last_position
                self.nb_mmer_selected -= k - m
            else:
                self.nb_mmer_selected += i + k - (pos_end + 1)
            self.handle_superkmer(
                ref[last_position : i + k], int(prev_val[n]),
                bool(prev_rev[n]))
            pos_end = i + k - 1
        # tail flush (SubSampler.cpp:441-454)
        if n_ev:
            last_position = int(pos[-1]) + 1
            t_val, t_rev, t_sel = int(val[-1]), bool(rev[-1]), bool(sel[-1])
        else:
            last_position = 0
            t_val, t_rev, t_sel = init
        i = L - k
        if L - last_position > k - 1:
            if t_sel:
                self.nb_mmer_selected -= m - 1
                self.handle_superkmer(
                    ref[last_position : i + k], t_val, t_rev)
            self.total_kmer_number += i - last_position + 1
            self.total_superkmer_number += 1


class _SharedSketchRun:
    """Shared multi-file sketch pipeline (fof mode).

    ONE prep pool / launcher thread / fetcher thread serves record
    batches from ALL files, so the per-transfer and per-dispatch costs
    are amortized across the whole fof corpus instead of being paid
    per file: medium records from different files stack into the
    same grouped H2D + fused dispatches + ONE stacked D2H fetch, and
    per-file host work (parse, clean+pack, assemble, serialize)
    overlaps other files' device work.  The reference fans fof entries
    to an OpenMP pool where each thread owns its file end to end
    (SubSampler.cpp:771-798); here the device is one shared in-order
    resource, so the sharing must happen at the batch level instead.

    Stages (the single-file pipeline's, generalized):
    per file, the reader thread loads raw bytes and spans records; a
    2-worker prep pool cleans + 2-bit packs each chunk with ONE C call
    per short-record group (spsp_clean_pack_batch) writing rows of the
    device batch matrix directly; one launcher thread dispatches
    device work in global (file-major, record-ordered) order, batching
    medium records ACROSS chunk and file boundaries; the main thread
    assembles in the same global order into each file's own C
    finisher, so bucket first-insertion order follows record order per
    file (byte-exact serialization, reference SubSampler.h:62).  A
    file serializes as soon as its last chunk drains, overlapping the
    next file's device work.

    Correctness invariants:
      * every member shares identical sketch parameters (sketch_fof
        groups mixed-parameter items into separate runs);
      * records of one file assemble in record order into that file's
        finisher; files finalize in fof order;
      * speculative capacities (sel/kmer caps, batch selection rate)
        live on the run and are written back to each member at the
        end, so single-file behavior is unchanged.
    """

    _FETCH_BATCH = 16
    _CHUNK_BYTES = 4 << 20
    _CHUNK_RECS = 4096
    # superbatch budget: raw bytes phased through the device together
    # (host holds ~1.25x this live; device holds ~0.25x packed)
    _SB_BYTES = 256 << 20

    def __init__(self, items, on_result=None):
        self.on_result = on_result      # callback(member_idx, raw)
        self.items = list(items)        # [(ss, path)] — same params
        ss0 = self.items[0][0]
        self.ss0 = ss0
        self.k, self.m = ss0.k, ss0.m
        thr = ss0.threshold
        self.thr = thr
        self.thr_w = (jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF))
        self.extra = ss0._tile_extra
        self.select_all = ss0.s <= 1
        self.fused_single = engine() == "gpu"
        self.margin = 2 * (2 * self.k - self.m + 2) + 128
        self.short_ok = ss0.scan_engine == "field"
        self.sel_guess = ss0._sel_cap_guess
        self.kmer_guess = ss0._kmer_cap_guess
        self.rate = ss0._batch_sel_rate
        self.batch = []                 # staging: [(rec, slab, L, own)]
        self.staged = []                # staged medium batches

    # ---- prep: per chunk, ONE C call per short group ----
    def _prep_chunk(self, ss, data, spans_chunk):
        from supersampler_tpu.io.fasta import clean_dna
        from supersampler_tpu.native import (clean_pack_batch_native,
                                             clean_pack_native)
        from supersampler_tpu.utils.profiling import phase

        k = self.k
        extra = self.extra
        with phase("prep"):
            routes = [None] * len(spans_chunk)
            bygroup = {}          # own -> [(rec_idx, start, end)]
            for i, (s, e) in enumerate(spans_chunk):
                n_raw = e - s
                if (self.short_ok
                        and n_raw + self.margin <= ss._SHORT_MAX):
                    own = max(1024, padded_size(n_raw, self.margin))
                    bygroup.setdefault(own, []).append((i, s, e))
                    continue
                plan = ss._plan_geometry(n_raw)
                if plan is None:
                    routes[i] = ("legacy", clean_dna(data[s:e]))
                    continue
                own, n_tiles = plan
                raw = np.frombuffer(data, np.uint8, n_raw, s)
                ref, slab, L = clean_pack_native(
                    raw, n_tiles * own + extra, 128)
                if L < k:
                    routes[i] = ("skip",)
                    continue
                if n_tiles > 1:
                    n2 = max(1, -(-(L - k) // own))
                    if n2 < n_tiles:
                        slab = slab[: (128 + n2 * own + extra) >> 2]
                        n_tiles = n2
                routes[i] = ("field", ref, slab, L, own, n_tiles)

            groups = []
            for own, members in bygroup.items():
                R = len(members)
                R_pad = _pow2_ge(max(R, 8))
                starts = np.fromiter((s for _, s, _ in members),
                                     np.int64, R)
                ends = np.fromiter((e for _, _, e in members),
                                   np.int64, R)
                raw_lens = ends - starts
                ref_offs = np.zeros(R + 1, np.int64)
                np.cumsum(raw_lens, out=ref_offs[1:])
                ref_pool = np.empty(max(int(ref_offs[-1]), 1),
                                    np.uint8)
                pack = np.zeros((R_pad, own >> 2), np.uint8)
                pack_offs = (np.arange(R, dtype=np.int64)
                             * (own >> 2))
                lens = clean_pack_batch_native(
                    np.frombuffer(data, np.uint8), starts, ends,
                    ref_pool, ref_offs[:R], pack, pack_offs,
                    np.full(R, own, np.int64))
                lengths = np.zeros(R_pad, np.int32)
                lengths[:R] = np.where(lens >= k, lens, 0)
                gi = len(groups)
                groups.append({
                    "ss": ss, "own": own, "pack": pack,
                    "lengths": lengths, "ref_pool": ref_pool,
                    "ref_offs": ref_offs, "ref_lens": lens, "R": R})
                for slot, (i, _s, _e) in enumerate(members):
                    routes[i] = (("skip",) if lengths[slot] == 0
                                 else ("grp", gi, slot))
            return routes, groups

    def _dispatch_single(self, slab, L, own, cap):
        """One single-tile record's compact array: one fused program on
        the GPU, split dispatches on the CPU (fused tracing is
        compile-heavy on the CPU backend for no dispatch win)."""
        from supersampler_tpu.ops.field import (field_entry_init,
                                                resolve_field,
                                                scan_resolve_single)

        k, m = self.k, self.m
        P_t = own + self.extra
        if self.fused_single:
            return scan_resolve_single(jnp.asarray(slab), k, m, P_t,
                                       cap, jnp.int32(L), *self.thr_w)
        ext = jnp.asarray(slab)
        ft = device_scan_field_packed(ext[32:], k, m, P_t,
                                      jnp.int32(L), True)
        entry = field_entry_init(ft, *self.thr_w)
        return resolve_field(ft, k, m, cap, entry, *self.thr_w)

    # ---- phased launcher (upload -> dispatch -> fetch) ----
    # Each superbatch phases ALL its uploads before any compute
    # dispatch, and fetches are stacked so each transfer's fixed cost
    # amortizes over many records. Whether the phasing pays on a GPU
    # over PCIe (it gives up copy/compute overlap) is unmeasured.
    def _timed_get(self, stacked):
        from supersampler_tpu.utils.profiling import phase

        with phase("device+fetch"):
            return jax.device_get(stacked)

    def _stage_batch(self):
        """Upload the accumulated medium records as ONE stacked H2D
        put (no compute); dispatch happens in the dispatch phase."""
        if not self.batch:
            return
        items = list(self.batch)
        self.batch = []
        if len(items) == 1:
            dev = jnp.asarray(items[0][1])
        else:
            dev = jnp.asarray(np.stack([s for _, s, _, _ in items]))
        st = {"dev": dev, "items": items}
        self.staged.append(st)
        for i, (rec, slab, L, own) in enumerate(items):
            rec.update(slab=slab, L=L, own=own, staged=st,
                       slot=i if len(items) > 1 else None)

    def _dispatch_staged(self, st):
        """Dispatch the fused per-record programs of one staged medium
        batch; the stacked result is fetched as ONE transfer."""
        items = st["items"]
        cap = _pow2_ge(max(
            items[0][3] if self.select_all else self.sel_guess,
            4096))
        if len(items) == 1:
            _r, _s, L, own = items[0]
            stacked = self._dispatch_single(st["dev"], L, own, cap)
        else:
            arrs = [self._dispatch_single(st["dev"][i], L, own, cap)
                    for i, (_, _, L, own) in enumerate(items)]
            stacked = _stack_arrs(arrs)
        st["stacked"] = stacked
        for rec, _s, _L, _o in items:
            rec["cap"] = cap

    def _fetch_staged(self, st):
        stacked = st["stacked"]
        try:
            stacked.copy_to_host_async()
        except AttributeError:
            pass
        fut = self.fetcher.submit(self._timed_get, stacked)
        for rec, _s, _L, _o in st["items"]:
            rec["fut"] = fut

    def _short_cap(self, positions: int) -> int:
        if self.select_all:
            return _pow2_ge(positions)
        guess = int(self.rate * positions * 2)
        return _pow2_ge(max(4096, guess))

    def _dispatch_group(self, g):
        from supersampler_tpu.ops.field import scan_resolve_batch

        own = g["own"]
        cap = self._short_cap(g["lengths"].size * own)
        g["arr"] = scan_resolve_batch(
            g["dev"] if "dev" in g else jnp.asarray(g["pack"]),
            self.k, self.m, own, cap,
            jnp.asarray(g["lengths"]), *self.thr_w)
        g["cap"] = cap

    def _fetch_group(self, g):
        arr = g.pop("arr")
        try:
            arr.copy_to_host_async()
        except AttributeError:
            pass
        g["fut"] = self.fetcher.submit(self._timed_get, arr)

    def _upload_chunk(self, pfut, entry_):
        """Phase U (launcher thread): device puts for one chunk's
        payloads — group pack matrices, medium-slab stacks, multi-tile
        slabs — and record-route bookkeeping. NO compute dispatches
        happen here: within a superbatch every byte lands on the
        device before the first program runs."""
        from supersampler_tpu.utils.profiling import phase

        routes, groups = pfut.result()
        entry_["routes"] = routes
        entry_["groups"] = groups
        recs = entry_["recs"]
        ss = entry_["ss"]
        k = self.k
        with phase("upload"):
            for g in groups:
                g["ss"] = ss
                g["dev"] = jnp.asarray(g["pack"])
            for i, p in enumerate(routes):
                if p is None or p[0] in ("skip", "grp"):
                    continue
                rec = recs[i]
                rec["ss"] = ss
                if p[0] == "legacy":
                    ref = p[1]
                    if len(ref) < k:
                        routes[i] = ("skip",)
                        continue
                    rec["ref"] = ref
                    continue
                _, ref, slab, L, own, n_tiles = p
                rec["ref"] = ref
                if n_tiles > 1:
                    rec["slab_dev"] = jnp.asarray(slab)
                    rec["plan"] = (L, own, n_tiles)
                    continue
                if self.batch and self.batch[0][1].size != slab.size:
                    self._stage_batch()  # stacks must be same-shaped
                self.batch.append((rec, slab, L, own))
                if len(self.batch) >= self._FETCH_BATCH:
                    self._stage_batch()

    def _dispatch_entries(self, entries):
        """Phase C+F (launcher thread): dispatch every compute of the
        superbatch in record order, then enqueue the stacked fetches in
        chunk order (a D2H blocks the in-order stream, so they run
        after ALL computes)."""
        from supersampler_tpu.utils.profiling import phase

        self._stage_batch()
        with phase("dispatch"):
            staged_iter = iter(self.staged)
            seen = set()
            for entry_ in entries:
                routes = entry_["routes"]
                recs = entry_["recs"]
                ss = entry_["ss"]
                for g in entry_["groups"]:
                    self._dispatch_group(g)
                for i, p in enumerate(routes):
                    if p is None or p[0] in ("skip", "grp"):
                        continue
                    rec = recs[i]
                    if p[0] == "legacy":
                        ss.read_kmer += len(rec["ref"]) - self.k + 1
                        rec["dc"] = ss._launch_scan(rec["ref"])
                        continue
                    if "plan" in rec:
                        L, own, n_tiles = rec["plan"]
                        ss.read_kmer += L - self.k + 1
                        sel_guess = (own if self.select_all
                                     else self.sel_guess)
                        rec["dc"] = FieldChain(
                            rec["slab_dev"], n_tiles, self.k, self.m,
                            L, self.thr, own, self.extra,
                            sel_cap_guess=sel_guess,
                            kmer_cap_guess=self.kmer_guess,
                            select_all=self.select_all, dedup=False)
                        continue
                    ss.read_kmer += rec["L"] - self.k + 1
                    st = rec["staged"]
                    if id(st) not in seen:
                        seen.add(id(st))
                        self._dispatch_staged(st)
            # fetch pass: chunk order; a staged medium batch fetches at
            # its LAST record's chunk (it is complete only then)
            fetched = set()
            for entry_ in entries:
                for g in entry_["groups"]:
                    self._fetch_group(g)
                for rec in entry_["recs"]:
                    st = rec.get("staged")
                    if st is not None and id(st) in seen \
                            and rec is st["items"][-1][0]:
                        fetched.add(id(st))
                        self._fetch_staged(st)
            for st in self.staged:
                if id(st) in seen and id(st) not in fetched:
                    self._fetch_staged(st)
            self.staged = [st for st in self.staged
                           if id(st) not in seen]

    # ---- assembly ----
    def _resolve_group(self, g):
        """Blocking: ensure the group's fetch is parsed (with cap
        retries) into heads + record-major event arrays."""
        from supersampler_tpu.ops.field import (parse_batched_heads,
                                                scan_resolve_batch)

        if "heads" in g:
            return
        a = g["fut"].result()
        cap = g["cap"]
        B_n = g["lengths"].size
        gst, n_total, heads, pos, last, val, rev = \
            parse_batched_heads(a, cap, B_n)
        while pos is None:        # truncated: re-dispatch
            cap = _pow2_ge(n_total)
            arr = scan_resolve_batch(
                jnp.asarray(g["pack"]), self.k, self.m, g["own"], cap,
                jnp.asarray(g["lengths"]), *self.thr_w)
            a = jax.device_get(arr)
            gst, n_total, heads, pos, last, val, rev = \
                parse_batched_heads(a, cap, B_n)
        g["heads"] = heads
        g["pos"], g["last"] = pos, last
        g["val"], g["rev"] = val, rev
        g["span_offs"] = np.zeros(B_n + 1, np.int64)
        np.cumsum(heads[:, 1], out=g["span_offs"][1:])
        positions = B_n * g["own"]
        if not self.select_all:
            self.rate = max(n_total / positions, 1e-6)

    def _ingest_run(self, g, a, b):
        """Assemble group g's slots [a, b) — one C ingest + one
        vectorized counter pass for the whole run."""
        ss = g["ss"]
        k = self.k
        heads = g["heads"][a:b]
        live = g["lengths"][a:b] > 0
        lens = g["ref_lens"][a:b]
        o = g["span_offs"]
        s0, s1 = int(o[a]), int(o[b])
        failed = heads[:, 0] != 0
        if failed.any():
            # pathological records: exact standalone fallback, order
            # preserved by splitting the run at each failure
            for j in range(a, b):
                if heads[j - a, 0] != 0:
                    if j > a:
                        self._ingest_run(g, a, j)
                    ref = bytes(g["ref_pool"][
                        g["ref_offs"][j] :
                        g["ref_offs"][j] + g["ref_lens"][j]])
                    dcf = ss._launch_scan(ref)
                    ss.read_kmer += len(ref) - k + 1
                    ss._assemble_from(ref, TpuSubsampler._fetch(dcf))
                    if j + 1 < b:
                        self._ingest_run(g, j + 1, b)
                    return
        ss.read_kmer += int(np.sum(lens[live] - k + 1))
        ss._span_counters_run(lens, heads, g["pos"][s0:s1],
                              g["last"][s0:s1], o[a : b + 1] - s0)
        tail_sel = heads[:, 6] != 0
        tail_last = np.where(
            tail_sel,
            np.where(heads[:, 2] > 0, heads[:, 3] + 1, 0),
            -1).astype(np.int64)
        nf = ss._nf()
        nf.add_spans_batch(
            g["ref_pool"], g["ref_offs"][a:b], lens,
            g["pos"][s0:s1], g["last"][s0:s1], g["val"][s0:s1],
            g["rev"][s0:s1], o[a : b + 1] - s0, tail_last,
            heads[:, 4].view(np.uint32), heads[:, 5].astype(np.uint8))

    def _finish_single(self, rec):
        from supersampler_tpu.ops.field import parse_field_array

        ss = rec["ss"]
        host = rec["fut"].result()
        a = host if rec["slot"] is None else host[rec["slot"]]
        cap, L, own = rec["cap"], rec["L"], rec["own"]
        n_sel = int(a[1])
        while int(a[0]) == 0 and n_sel > cap:
            cap = _pow2_ge(max(n_sel, 1))
            arr = self._dispatch_single(rec["slab"], L, own, cap)
            a = jax.device_get(arr)
            n_sel = int(a[1])
        if int(a[0]) != 0:
            legacy = TiledDeviceChain(
                rec["slab"], 1, self.k, self.m, L, self.thr,
                sel_cap_guess=max(4096, cap),
                select_all=self.select_all, own=own, extra=self.extra,
                dedup=False)
            comp = legacy.compact()
            n_sel = legacy.n_sel
        else:
            _st, comp, n_sel = parse_field_array(a, cap)
        if not self.select_all:
            self.sel_guess = max(4096, 2 * n_sel)
        ss._assemble_compact(rec["ref"], *comp)

    def _drain_chunk(self, entry_):
        from supersampler_tpu.utils.profiling import phase

        entry_["lfut"].result()
        entry_["dfut"].result()
        routes = entry_["routes"]
        groups = entry_["groups"]
        recs = entry_["recs"]
        ss = entry_["ss"]
        with phase("assemble"):
            run = None          # (gi, slot_a, slot_b)
            for i, p in enumerate(routes):
                if p is not None and p[0] == "grp":
                    gi, slot = p[1], p[2]
                    if run is not None and run[0] == gi \
                            and run[2] == slot:
                        run = (gi, run[1], slot + 1)
                    else:
                        if run is not None:
                            self._resolve_group(groups[run[0]])
                            self._ingest_run(groups[run[0]], run[1],
                                             run[2])
                        run = (gi, slot, slot + 1)
                    continue
                if run is not None:
                    self._resolve_group(groups[run[0]])
                    self._ingest_run(groups[run[0]], run[1], run[2])
                    run = None
                if p is None or p[0] == "skip":
                    continue
                rec = recs[i]
                if "dc" in rec:
                    ss._assemble_from(rec["ref"],
                                      TpuSubsampler._fetch(rec["dc"]))
                    continue
                if "fut" not in rec:
                    raise RuntimeError(
                        "record missed its dispatch batch")
                self._finish_single(rec)
            if run is not None:
                self._resolve_group(groups[run[0]])
                self._ingest_run(groups[run[0]], run[1], run[2])

    def _finalize_file(self, fi, results):
        from supersampler_tpu.core.scalar import MASK64
        from supersampler_tpu.utils.profiling import phase

        ss = self.items[fi][0]
        ss.nb_mmer_selected = (ss.nb_mmer_selected
                               - (self.m - 1)) & MASK64
        with phase("serialize"):
            results[fi] = ss.serialize()
        if self.on_result is not None:
            self.on_result(fi, results[fi])

    def run(self):
        import collections
        import concurrent.futures

        from supersampler_tpu.io.fasta import stream_fasta_spans
        from supersampler_tpu.utils.profiling import device_trace

        results = [None] * len(self.items)
        pending = collections.deque()     # chunk entries, global order
        left = [0] * len(self.items)      # undrained chunks per file
        done_reading = [False] * len(self.items)
        next_final = 0

        def try_finalize():
            # files finalize strictly in fof order, each as soon as its
            # last chunk drains
            nonlocal next_final
            while (next_final < len(self.items)
                   and done_reading[next_final]
                   and left[next_final] == 0):
                self._finalize_file(next_final, results)
                next_final += 1

        def drain_one():
            entry_ = pending.popleft()
            fi = entry_["fi"]
            self._drain_chunk(entry_)
            left[fi] -= 1
            try_finalize()

        with device_trace("sketch_fof"), \
                concurrent.futures.ThreadPoolExecutor(2) as preppers, \
                concurrent.futures.ThreadPoolExecutor(1) as fetcher, \
                concurrent.futures.ThreadPoolExecutor(1) as launcher:
            self.fetcher = fetcher
            self.launcher = launcher

            # superbatch assembly: chunks accumulate (file-major, in
            # order) until the raw-byte budget, then the whole batch
            # phases through upload -> dispatch -> fetch while the
            # PREVIOUS superbatch's chunks drain on this thread
            sb_entries: list = []
            sb_bytes = 0

            def close_superbatch():
                nonlocal sb_entries, sb_bytes
                if not sb_entries:
                    return
                entries = sb_entries
                sb_entries, sb_bytes = [], 0
                dfut = self.launcher.submit(self._dispatch_entries,
                                            entries)
                for e in entries:
                    e["dfut"] = dfut
                # previous superbatch fully drains before the next one
                # is assembled (bounds host+device memory at ~2 SBs)
                while pending:
                    drain_one()
                pending.extend(entries)

            for fi, (ss, path) in enumerate(self.items):
                # bounded-memory input: each streamed block is one
                # chunk (O(window + largest record) host bytes per
                # file; a background thread reads ahead)
                blocks = _prefetch_iter(stream_fasta_spans(
                    path, self._CHUNK_BYTES, self._CHUNK_RECS))
                for data, chunk in blocks:
                    entry_ = {"fi": fi, "ss": ss, "data": data,
                              "recs": [{} for _ in chunk]}
                    pf = preppers.submit(self._prep_chunk, ss, data,
                                         chunk)
                    entry_["lfut"] = launcher.submit(
                        self._upload_chunk, pf, entry_)
                    left[fi] += 1
                    sb_entries.append(entry_)
                    sb_bytes += sum(e - s for s, e in chunk)
                    if sb_bytes >= self._SB_BYTES:
                        close_superbatch()
                done_reading[fi] = True
                try_finalize()           # empty / fully-drained file
            close_superbatch()
            while pending:
                drain_one()
            try_finalize()
        # adaptive capacities persist on the members (single-file
        # behavior unchanged: the one member gets the final values)
        for ss, _ in self.items:
            ss._sel_cap_guess = self.sel_guess
            ss._batch_sel_rate = self.rate
        return results


def _prefetch_iter(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue, so
    file reading/decompression overlaps prep/device work without
    unbounded buffering."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(_END)
        except BaseException as e:        # surface on the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _shared_params_key(ss):
    return (ss.k, ss.m, ss.threshold, ss.s, ss.abundance,
            ss.scan_engine, ss._tile_own, ss._tile_extra,
            ss._SHORT_MAX, ss._SHORT_BATCH_MAX)


def sketch_fof(items, on_result=None):
    """Sketch many (subsampler, fasta_path) pairs through ONE shared
    device pipeline (see _SharedSketchRun). Returns the serialized
    sketch bytes per item, aligned with the input (None for
    unopenable inputs, matching sketch_file's contract). Items whose
    configuration requires the compat path (device dedup on, no
    native toolchain) run through _sketch_file_compat individually;
    mixed-parameter items split into per-parameter shared runs.

    on_result(idx, raw): called as each item's sketch bytes become
    available (a file finalizes as soon as its last chunk drains), so
    output writing can overlap the remaining device work."""
    import os
    import sys

    from supersampler_tpu.native import clean_pack_native

    results = [None] * len(items)
    shared: dict = {}               # params key -> [(idx, ss, path)]
    for idx, (ss, path) in enumerate(items):
        if not os.path.exists(path):
            log = ss.log or sys.stdout
            print("Problem with file opening", file=log)
            print(f"Can't open file: {path}", file=log)
            continue
        if (ss._dedup_on() or ss._nf() is None
                or clean_pack_native(np.zeros(0, np.uint8), 4, 4)
                is None):
            results[idx] = ss._sketch_file_compat(path)
            if on_result is not None and results[idx] is not None:
                on_result(idx, results[idx])
            continue
        shared.setdefault(_shared_params_key(ss), []).append(
            (idx, ss, path))
    for members in shared.values():
        gidx = [idx for idx, _, _ in members]
        cb = (None if on_result is None
              else lambda mi, raw: on_result(gidx[mi], raw))
        run = _SharedSketchRun([(ss, path) for _, ss, path in members],
                               on_result=cb)
        outs = run.run()
        for (idx, _ss, _path), out in zip(members, outs):
            results[idx] = out
    return results
