"""Sync-field resolution (ops/field.py) == legacy successor-table +
serial-walker path, on the full compact contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops import u64 as U
from supersampler_tpu.ops.field import (field_carry, field_entry_init,
                                        parse_field_array, resolve_field,
                                        scan_field_2d)
from supersampler_tpu.ops.minimizer import scan_tables_2d
from supersampler_tpu.ops.walker import DeviceChain

_scan_legacy = jax.jit(scan_tables_2d, static_argnums=(1, 2, 3))
_scan_field = jax.jit(scan_field_2d, static_argnums=(1, 2, 3, 5))


def _codes(rng, L, P, kind="random"):
    c = np.zeros(P, np.uint8)
    if kind == "random":
        c[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    elif kind == "repeat":
        unit = rng.integers(0, 4, 61, dtype=np.uint8)
        c[:L] = np.tile(unit, L // 61 + 1)[:L]
    elif kind == "homopolymer":
        c[:L] = rng.integers(0, 4, L, dtype=np.uint8)
        c[L // 3 : L // 3 + 150] = 2
        c[2 * L // 3 : 2 * L // 3 + 80] = 0
    return c


def _both(codes, L, P, k, m, s, sel_cap=4096):
    thr = compute_threshold(k, m, s)
    thrv = U.U64(jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF))
    t = _scan_legacy(jnp.asarray(codes), k, m, P, jnp.int32(L), thrv)
    legacy = DeviceChain(t).compact()
    ft = _scan_field(jnp.asarray(codes), k, m, P, jnp.int32(L), True)
    entry = field_entry_init(ft, jnp.uint32(thr >> 32),
                             jnp.uint32(thr & 0xFFFFFFFF))
    arr = np.asarray(resolve_field(ft, k, m, sel_cap, entry,
                                   jnp.uint32(thr >> 32),
                                   jnp.uint32(thr & 0xFFFFFFFF)))
    status, comp, n_sel = parse_field_array(arr, sel_cap)
    return legacy, status, comp


@pytest.mark.parametrize("L,s,seed,k,m,kind", [
    (5000, 10.0, 0, 31, 11, "random"),
    (5000, 1.0, 1, 31, 11, "random"),
    (8000, 2.0, 2, 31, 11, "repeat"),
    (6000, 5.0, 3, 31, 11, "homopolymer"),
    (4000, 3.0, 4, 63, 15, "random"),
    (4000, 3.0, 5, 15, 5, "random"),
    (3000, 2.0, 6, 21, 7, "repeat"),
])
def test_field_matches_legacy(L, s, seed, k, m, kind):
    rng = np.random.default_rng(seed)
    P = 8192
    codes = _codes(rng, L, P, kind)
    legacy, status, comp = _both(codes, L, P, k, m, s)
    assert status == 0, "unresolved blocks on benign input"
    for i, (a, b) in enumerate(zip(comp, legacy)):
        assert np.all(np.asarray(a) == np.asarray(b)), (
            i, np.asarray(a), np.asarray(b))


def test_field_pipeline_end_to_end():
    """Full sketch through the field engine (single + tiled + dedup) ==
    oracle bytes."""
    from supersampler_tpu.oracle.subsampler import OracleSubsampler
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    class FieldSub(TpuSubsampler):
        scan_engine = "field"

    class FieldTiledSub(FieldSub):
        _tile_own = 2048
        _tile_extra = 512

    rng = np.random.default_rng(23)
    ref = "".join("ACGT"[c] for c in rng.integers(0, 4, 9000))
    for cls, s in ((FieldSub, 20.0), (FieldSub, 2.0),
                   (FieldTiledSub, 20.0), (FieldTiledSub, 1.0)):
        oracle = OracleSubsampler(k=31, m=11, s=s)
        oracle.scan_sequence(ref)
        ss = cls(k=31, m=11, s=s)
        ss.scan_sequence(ref)
        assert ss.serialize() == oracle.serialize(), (cls.__name__, s)


def test_field_fallback_on_sync_desert():
    """A multi-kilobase homopolymer has no strict hash minima, starving
    the sync decomposition past its pass budget; the chain must flag
    failure and transparently re-run the exact legacy path."""
    from supersampler_tpu.oracle.subsampler import OracleSubsampler
    from supersampler_tpu.sketch.pipeline import FieldChain, TpuSubsampler

    class FieldSub(TpuSubsampler):
        scan_engine = "field"

    rng = np.random.default_rng(13)
    ref = ("".join("ACGT"[c] for c in rng.integers(0, 4, 500))
           + "T" * 3000
           + "".join("ACGT"[c] for c in rng.integers(0, 4, 500)))
    ss = FieldSub(k=31, m=11, s=2.0)
    dc = ss._launch_scan(ref.encode())
    assert isinstance(dc, FieldChain)
    ss._finish_scan(ref, dc)
    assert dc.fallback_tiles, \
        "sync desert should have forced the walker fallback"
    oracle = OracleSubsampler(k=31, m=11, s=2.0)
    oracle.scan_sequence(ref)
    assert ss.serialize() == oracle.serialize()


def test_field_fallback_is_tile_granular():
    """A homopolymer desert confined to ONE tile must send only that
    tile to the walker; the surrounding tiles stay on the field path
    and the sketch remains byte-exact (machine state converts
    walker<->field at the tile boundaries)."""
    from supersampler_tpu.oracle.subsampler import OracleSubsampler
    from supersampler_tpu.sketch.pipeline import FieldChain, TpuSubsampler

    OWN = 2048

    class SmallTiles(TpuSubsampler):
        scan_engine = "field"
        _tile_own = OWN
        _tile_extra = 512

    rng = np.random.default_rng(77)
    mk = lambda n: "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    # tiles 0-1 healthy, tile 2 a desert, tiles 3-4 healthy
    ref = mk(2 * OWN + 300) + "A" * 1500 + mk(2 * OWN - 300)
    for s in (2.0, 20.0):
        ss = SmallTiles(k=31, m=11, s=s)
        dc = ss._launch_scan(ref.encode())
        assert isinstance(dc, FieldChain) and dc._n_tiles >= 5
        ss._finish_scan(ref, dc)
        assert dc.fallback_tiles, "desert tile must fall back"
        assert len(dc.fallback_tiles) < dc._n_tiles, \
            "fallback must not consume every tile"
        assert 2 in dc.fallback_tiles
        oracle = OracleSubsampler(k=31, m=11, s=s)
        oracle.scan_sequence(ref)
        assert ss.serialize() == oracle.serialize(), s


def test_field_carry_chain_matches_single():
    """Two chained field regions == one region (tiling contract)."""
    k, m, s = 31, 11, 4.0
    L = 3500
    OWN = 2048
    P1 = 2048 + 512
    rng = np.random.default_rng(17)
    full = np.zeros(4096, np.uint8)
    full[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    thr = compute_threshold(k, m, s)
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)

    # single region
    legacy, status, want = _both(full, L, 4096, k, m, s)
    assert status == 0

    # tiled: region 0 owns [0, 2048), region 1 the rest
    def region(t0, first, entry, length):
        c = np.zeros(P1, np.uint8)
        src = full[t0 : t0 + P1]
        c[: src.size] = src
        ft = _scan_field(jnp.asarray(c), k, m, P1, jnp.int32(length),
                         first)
        if entry is None:
            entry = field_entry_init(ft, thi, tlo)
        arr = resolve_field(ft, k, m, 4096, entry, thi, tlo)
        return arr

    # region 0: resolve only the owned part by... the field path owns
    # everything it scans; to emulate tiles, the pipeline passes OWN-
    # sized tables. Here: scan P1 but with length so that last_i caps
    # inside the owned region is wrong — instead chain full regions:
    # region 0 scans [0, 2560) with sequence length clamped to cover
    # exactly its owned loop range via the pipeline's convention.
    arr0 = region(0, True, None, min(L, OWN + k))   # events j <= OWN-1
    carry = field_carry(arr0, OWN)
    arr1 = region(OWN, False, carry, L - OWN)
    s0, c0, _ = parse_field_array(np.asarray(arr0), 4096)
    s1, c1, _ = parse_field_array(np.asarray(arr1), 4096)
    assert s0 == 0 and s1 == 0
    pos = np.concatenate([c0[0], c1[0] + OWN])
    last = np.concatenate([c0[1], c1[1] + OWN])
    val = np.concatenate([c0[2], c1[2]])
    rev = np.concatenate([c0[3], c1[3]])
    assert np.all(pos == want[0])
    assert np.all(last == want[1])
    assert np.all(val == want[2])
    assert np.all(rev == want[3])
    assert c0[4] + c1[4] == want[4]          # n_ev
    assert c1[5] + OWN == want[5]            # last_ev_pos
    assert (c1[6], c1[7], c1[8]) == (want[6], want[7], want[8])

