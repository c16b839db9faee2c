"""Chain walker (ops/walker.py) vs the pointer-doubling reference path.

The serial while_loop walk (what the CPU runs) is checked against
ops/chain.compact_chain on fuzzed inputs, and the doubling walk (what
the GPU runs) against the serial walk, byte for byte.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops import u64 as U
from supersampler_tpu.ops.chain import compact_chain
from supersampler_tpu.ops.minimizer import scan_tables_2d
from supersampler_tpu.ops.walker import (DeviceChain, make_init5,
                                         pack_succ, walk_doubling,
                                         walk_xla, _BP, _init5_from_tables)


def _tables(L, s, seed, k=31, m=11):
    P = 1024
    while P < L + 200:
        P *= 2
    thr = compute_threshold(k, m, s)
    rng = np.random.default_rng(seed)
    codes = np.zeros(P, np.uint8)
    codes[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    return jax.jit(scan_tables_2d, static_argnums=(1, 2, 3))(
        jnp.asarray(codes), k, m, P, jnp.int32(L),
        U.U64(jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)))


@pytest.mark.parametrize("L,s,seed", [
    (600, 10.0, 0), (1500, 2.0, 1), (900, 1.0, 2), (3000, 1000.0, 3),
    (5000, 5.0, 4),
])
def test_walker_matches_pointer_doubling(L, s, seed):
    t = _tables(L, s, seed)
    ref = compact_chain(t)
    got = DeviceChain(t).compact()
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.all(a == b), (i, a, b)


def test_walker_overflow_retry():
    """A too-small speculative capacity must transparently re-compact."""
    t = _tables(2000, 1.0, 7)   # s=1: every boundary selected
    ref = compact_chain(t)
    dc = DeviceChain(t, sel_cap_guess=16)
    got = dc.compact()
    assert dc.n_sel > 16
    for a, b in zip(ref, got):
        assert np.all(np.asarray(a) == np.asarray(b))


@pytest.mark.parametrize("L,s,seed,tile", [
    (700, 3.0, 11, False), (3000, 1.0, 12, False),
    (5000, 1000.0, 13, False), (6000, 2.0, 14, False),
    (700, 3.0, 11, True), (3000, 1.0, 12, True), (5000, 1000.0, 13, True),
    (6000, 2.0, 14, True), (900, 5.0, 15, None),
])
def test_doubling_walk_matches_serial_walk(L, s, seed, tile):
    """walk_doubling (the GPU walk) == walk_xla (the CPU walk) on every
    output: emit lists, counts and the final state. tile=False walks a
    whole sequence from its initial election; tile=True walks the first
    _BP positions entering mid-chain with an open super-k-mer from an
    earlier tile (the tiled and fallback paths); tile=None enters with
    the next event already past the walk (an empty walk)."""
    t = _tables(L, s, seed)
    if tile is None:
        packed, init5 = pack_succ(t, _BP), make_init5(_BP + 3, 1, 1, -2, 0)
    elif tile:
        packed = pack_succ(t, _BP)
        init5 = make_init5(37 + seed, seed % 2, 1, -7, 1)
    else:
        n = int(t.nxt_pos_a.shape[0])
        packed = pack_succ(t, ((n + _BP - 1) // _BP) * _BP)
        init5 = _init5_from_tables(t)
    want = walk_xla(packed, init5)
    got = walk_doubling(packed, init5)
    assert int(want[4][0]) > 0 or tile is None     # n_ev
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
