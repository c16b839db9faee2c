"""Loader for the native host-runtime library (csrc/spsp_native.c).

The library is built on demand with the system compiler into build/,
under a name keyed on its sources, its compiler flags and the host CPU:
a checkout copied to another machine (or a source edit) builds its own
library instead of loading one compiled for another CPU. Python
fallbacks exist for every entry point so the package works without a
toolchain, but the native path is authoritative for long-double math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_ROOT, "csrc", f)
         for f in ("spsp_native.c", "spsp_finish.c", "spsp_io.c")]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def _host_cpu() -> str:
    """The CPU model and feature flags -march=native compiles for."""
    desc = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features"):
                    desc += "|" + line.strip()
                if not line.strip() and "|" in desc:
                    break
    except OSError:
        pass
    return desc


def lib_path() -> str:
    """build/libspsp_native-<key>.so for these sources, flags and CPU."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(_ROOT, "build",
                        f"libspsp_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "g++", "clang"):
        try:
            r = subprocess.run([cc] + _FLAGS + ["-o", tmp] + _SRCS
                               + ["-lm"], capture_output=True)
        except FileNotFoundError:
            continue
        if r.returncode == 0:
            os.replace(tmp, out)      # atomic: concurrent loaders see
            return True               # a whole library or none
    return False


def get_lib():
    """Return the loaded native library, building it if needed;
    None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not all(os.path.exists(s) for s in _SRCS):
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.spsp_threshold.restype = ctypes.c_uint64
        lib.spsp_threshold.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_double]
        lib.spsp_xxh64_u64.restype = ctypes.c_uint64
        lib.spsp_xxh64_u64.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.spsp_walk_chain.restype = ctypes.c_int64
        lib.spsp_walk_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint8,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.spsp_finish_new.restype = ctypes.c_void_p
        lib.spsp_finish_new.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.spsp_finish_free.argtypes = [ctypes.c_void_p]
        lib.spsp_finish_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.spsp_finish_serialize.restype = ctypes.c_int64
        lib.spsp_finish_serialize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_void_p]
        lib.spsp_finish_release.argtypes = [ctypes.c_char_p]
        lib.spsp_clean_codes.restype = ctypes.c_int64
        lib.spsp_clean_codes.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.spsp_pack_halo.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64]
        lib.spsp_clean_pack.restype = ctypes.c_int64
        lib.spsp_clean_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.spsp_clean_pack_batch.argtypes = [
            ctypes.c_void_p] + [ctypes.c_void_p] * 2 \
            + [ctypes.c_int64] + [ctypes.c_void_p] * 6
        lib.spsp_finish_spans_batch.argtypes = [
            ctypes.c_void_p] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int64] + [ctypes.c_void_p] * 8
        _lib = lib
        return _lib


class NativeFinisher:
    """ctypes wrapper over the C k-mer store + reconstructor +
    serializer (csrc/spsp_finish.c); None-able via available()."""

    @staticmethod
    def available() -> bool:
        lib = get_lib()
        return lib is not None

    def __init__(self, k: int, m: int, abundance: int):
        self._lib = get_lib()
        self._h = self._lib.spsp_finish_new(k, m, abundance)

    def add_spans(self, ref, pos, last, val, rev) -> None:
        """ref: the cleaned sequence as bytes OR a uint8 numpy array
        (passed zero-copy by pointer)."""
        import numpy as np

        pos = np.ascontiguousarray(pos, np.int64)
        last = np.ascontiguousarray(last, np.int64)
        val = np.ascontiguousarray(val, np.uint32)
        rev = np.ascontiguousarray(rev, np.uint8)
        if isinstance(ref, np.ndarray):
            ref = np.ascontiguousarray(ref, np.uint8)
            ref_ptr, ref_len = ref.ctypes.data, ref.size
        else:
            ref_ptr, ref_len = ref, len(ref)
        self._lib.spsp_finish_spans(
            self._h, ref_ptr, ref_len, len(pos), pos.ctypes.data,
            last.ctypes.data, val.ctypes.data, rev.ctypes.data)

    def add_spans_batch(self, ref_pool, ref_offs, ref_lens, pos, last,
                        val, rev, span_offs, tail_last, tail_val,
                        tail_rev) -> None:
        """Ingest a contiguous run of records in ONE C call (record
        order preserved — the store's first-insertion order is part of
        the byte-exact serialization contract). Arrays: ref_pool u8 +
        per-record offsets/lengths i64; record-major event arrays with
        span_offs (n_rec+1) boundaries; per-record tails (tail_last
        < 0 = no selected tail)."""
        import numpy as np

        n_rec = len(ref_lens)
        c = lambda a, dt: np.ascontiguousarray(a, dt)
        ref_pool = c(ref_pool, np.uint8)
        ref_offs = c(ref_offs, np.int64)
        ref_lens = c(ref_lens, np.int64)
        pos = c(pos, np.int64)
        last = c(last, np.int64)
        val = c(val, np.uint32)
        rev = c(rev, np.uint8)
        span_offs = c(span_offs, np.int64)
        tail_last = c(tail_last, np.int64)
        tail_val = c(tail_val, np.uint32)
        tail_rev = c(tail_rev, np.uint8)
        self._lib.spsp_finish_spans_batch(
            self._h, ref_pool.ctypes.data, ref_offs.ctypes.data,
            ref_lens.ctypes.data, n_rec, pos.ctypes.data,
            last.ctypes.data, val.ctypes.data, rev.ctypes.data,
            span_offs.ctypes.data, tail_last.ctypes.data,
            tail_val.ctypes.data, tail_rev.ctypes.data)

    def serialize(self):
        """Returns (payload_bytes, counters[6]): seen_kmers,
        seen_skmers, seen_max_skmers, seen_unique, total_kmer_recon,
        n_buckets."""
        import numpy as np

        out = ctypes.c_char_p()
        counters = np.zeros(6, np.int64)
        n = self._lib.spsp_finish_serialize(
            self._h, ctypes.byref(out), counters.ctypes.data)
        data = ctypes.string_at(out, n)
        self._lib.spsp_finish_release(out)
        return data, counters

    def __del__(self):
        try:
            if self._h:
                self._lib.spsp_finish_free(self._h)
                self._h = None
        except Exception:
            pass


def walk_chain_native(nxt_pos_a, nxt_adopt_a, nxt_pos_r, nxt_adopt_r,
                      init_pos: int, init_adopt: bool):
    """Fast event-chain walk over numpy successor tables.

    Returns (positions int32[], types uint8[]) or None if the native
    library is unavailable. Arrays must be C-contiguous int32/uint8.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = nxt_pos_a.shape[0]
    max_out = n + 1
    out_pos = np.empty(max_out, dtype=np.int32)
    out_type = np.empty(max_out, dtype=np.uint8)
    cnt = lib.spsp_walk_chain(
        nxt_pos_a.ctypes.data, nxt_adopt_a.ctypes.data,
        nxt_pos_r.ctypes.data, nxt_adopt_r.ctypes.data,
        int(init_pos), 1 if init_adopt else 0,
        out_pos.ctypes.data, out_type.ctypes.data, max_out)
    return out_pos[:cnt], out_type[:cnt]


def clean_pack_native(raw_view, padded: int, halo: int = 128):
    """One-pass clean + 2-bit pack (csrc/spsp_io.c spsp_clean_pack).

    raw_view: np.uint8 array (a zero-copy view into the file buffer is
    fine). Returns (ref_u8_array_of_cleaned_len, packed_u8_array, o) or
    None if the library is unavailable. halo and padded must be
    multiples of 4 with len(raw_view) <= padded (cleaning only
    shrinks)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    raw_view = np.ascontiguousarray(raw_view, np.uint8)
    n = raw_view.size
    ref = np.empty(max(n, 1), np.uint8)
    packed = np.empty((halo + padded) >> 2, np.uint8)
    o = lib.spsp_clean_pack(raw_view.ctypes.data, n, ref.ctypes.data,
                            packed.ctypes.data, halo, padded)
    return ref[:o], packed, int(o)


def clean_pack_batch_native(data_view, starts, ends, ref_pool,
                            ref_offs, pack_pool, pack_offs, padded):
    """One C call cleaning+packing every record of a chunk
    (csrc/spsp_io.c spsp_clean_pack_batch). Returns out_lens i64[n]
    or None if the library is unavailable. pack rows are written at
    pack_pool + pack_offs[r] with padded[r] positions, halo 0."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    c = lambda a, dt: np.ascontiguousarray(a, dt)
    data_view = c(data_view, np.uint8)
    starts = c(starts, np.int64)
    ends = c(ends, np.int64)
    ref_offs = c(ref_offs, np.int64)
    pack_offs = c(pack_offs, np.int64)
    padded = c(padded, np.int64)
    out_lens = np.empty(starts.size, np.int64)
    lib.spsp_clean_pack_batch(
        data_view.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        starts.size, ref_pool.ctypes.data, ref_offs.ctypes.data,
        pack_pool.ctypes.data, pack_offs.ctypes.data,
        padded.ctypes.data, out_lens.ctypes.data)
    return out_lens


def clean_codes_native(raw: bytes):
    """One-pass clean_dna + 2-bit code extraction (csrc/spsp_io.c).

    Returns (cleaned_ref_bytes, codes_uint8_array) or None if the
    native library is unavailable.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = len(raw)
    ref = np.empty(n, np.uint8)
    codes = np.empty(n, np.uint8)
    o = lib.spsp_clean_codes(raw, n, ref.ctypes.data, codes.ctypes.data)
    return ref[:o].tobytes(), codes[:o]


def pack_halo_native(codes, padded: int, halo: int = 0):
    """4:1 pack of 2-bit codes with `halo` zero positions prepended and
    zero fill to `padded` positions (csrc/spsp_io.c); None if the
    library is unavailable. halo and padded must be multiples of 4."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty((halo + padded) >> 2, np.uint8)
    lib.spsp_pack_halo(codes.ctypes.data, len(codes), out.ctypes.data,
                       halo, padded)
    return out


def threshold_native(k: int, m: int, s: float):
    """Exact FHS threshold via native long double; None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.spsp_threshold(k, m, float(s)))
