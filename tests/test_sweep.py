"""The GPU field sweep (ops/field.py _sweep_triton, Pallas through
Triton) in interpret mode == the XLA reference sweep (_sweep +
_lists_from_dense), on every output of the sweep contract. The
compiled kernel is checked against the same reference on the card
(tests/test_gpu_smoke.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops import field as F
from supersampler_tpu.ops.minimizer import pack_2bit_np

_scan = jax.jit(F.scan_field_2d, static_argnums=(1, 2, 3, 5))
_scan_b = jax.jit(F.scan_field_batched, static_argnums=(1, 2, 3))


def _codes(rng, L, P, kind):
    c = np.zeros(P, np.uint8)
    c[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    if kind == "homopolymer":
        c[L // 4 : L // 4 + 3000] = 3
    return c


def _zero_state(n):
    return F.FieldState(
        val=jnp.zeros((n,), jnp.uint32),
        h_hi=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
        h_lo=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
        p=jnp.zeros((n,), jnp.int32),
        last_ev=jnp.full((n,), -1, jnp.int32),
        n_ev=jnp.zeros((n,), jnp.int32))


def _pred_state(st, first):
    """Each lane's predecessor exit (lane 0 takes `first`'s lane 0)."""
    sh = lambda a, f: jnp.concatenate([f[:1], a[:-1]])
    return F.FieldState(*(sh(a, f) for a, f in zip(st, first)))._replace(
        n_ev=jnp.zeros_like(st.n_ev))


def _reference(args, capl):
    (tT, j0, lastiv, W, n_blk, st0, start, end, active, force,
     thi, tlo) = args
    st, ev, pval, plast, isent = F._sweep(tT, j0, lastiv, W, n_blk, st0,
                                          start, end, active, force,
                                          thi, tlo)
    return (st,) + F._lists_from_dense(ev, pval, plast, isent, j0,
                                       n_blk, capl)


def _single_args(kind, L, P, s, seed, prefix, held_entry=False):
    k, m = 31, 11
    W = k - m + 1
    rng = np.random.default_rng(seed)
    thr = compute_threshold(k, m, s)
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)
    t = _scan(jnp.asarray(_codes(rng, L, P, kind)), k, m, P,
              jnp.int32(L), True)
    n_blk = P // F._B
    tT = F._transpose_tables(t, n_blk)
    sync2 = t.sync.reshape(n_blk, F._B)
    has_sync = jnp.any(sync2, axis=1)
    fs = jnp.where(has_sync,
                   jnp.argmax(sync2, axis=1).astype(jnp.int32), F._B)
    j0 = jnp.arange(n_blk, dtype=jnp.int32) * F._B
    lastiv = jnp.broadcast_to(t.last_i, (n_blk,)).astype(jnp.int32)
    zst = _zero_state(n_blk)
    full = jnp.full((n_blk,), F._B, jnp.int32)
    suffix = (tT, j0, lastiv, W, n_blk, zst, fs, full, has_sync, True,
              thi, tlo)
    if not prefix and not held_entry:
        return suffix
    st1 = _reference(suffix, 16)[0]
    st0 = _pred_state(st1, zst)
    if held_entry:
        # a suffix pass entered with held (often selected) minimizers:
        # the forced entry events must still emit nothing
        return suffix[:5] + (st0,) + suffix[6:]
    return (tT, j0, lastiv, W, n_blk, st0,
            jnp.zeros((n_blk,), jnp.int32), fs,
            j0 <= t.last_i, False, thi, tlo)


def _batched_args(prefix):
    k, m, s = 31, 11, 3.0
    W = k - m + 1
    P_rec, B_n = 2048, 8
    rng = np.random.default_rng(11)
    thr = compute_threshold(k, m, s)
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)
    lens = rng.integers(300, P_rec - 200, B_n).astype(np.int32)
    lens[3] = 20                       # shorter than k: an inert record
    codes = np.zeros((B_n, P_rec), np.uint8)
    for b in range(B_n):
        codes[b, : lens[b]] = rng.integers(0, 4, lens[b], dtype=np.uint8)
    packed = np.stack([pack_2bit_np(c) for c in codes])
    t = _scan_b(jnp.asarray(packed), k, m, P_rec, jnp.asarray(lens))
    lpr = P_rec // F._B
    n_blk = B_n * lpr
    lanes = jnp.arange(n_blk, dtype=jnp.int32)
    j0 = (lanes % lpr) * F._B
    lastiv = t.last_i[lanes // lpr]
    tT = F._transpose_tables(t, n_blk)
    sync2 = t.sync.reshape(n_blk, F._B)
    has_sync = jnp.any(sync2, axis=1)
    fs = jnp.where(has_sync,
                   jnp.argmax(sync2, axis=1).astype(jnp.int32), F._B)
    zst = _zero_state(n_blk)
    full = jnp.full((n_blk,), F._B, jnp.int32)
    suffix = (tT, j0, lastiv, W, n_blk, zst, fs, full, has_sync, True,
              thi, tlo)
    if not prefix:
        return suffix
    st1 = _reference(suffix, 16)[0]
    return (tT, j0, lastiv, W, n_blk, _pred_state(st1, zst),
            jnp.zeros((n_blk,), jnp.int32), fs, j0 <= lastiv, False,
            thi, tlo)


CASES = {
    # name: (args builder, capl)
    "suffix": (lambda: _single_args("random", 7900, 8192, 5.0, 3, False),
               16),
    "prefix": (lambda: _single_args("random", 7900, 8192, 5.0, 3, True),
               16),
    "suffix_held_entry": (lambda: _single_args("random", 7900, 8192, 2.0,
                                               4, False, True), 16),
    "batched_suffix": (lambda: _batched_args(False), 16),
    "batched_prefix": (lambda: _batched_args(True), 16),
    # 40 lanes: not a multiple of the sweep block
    "ragged_lanes": (lambda: _single_args("random", 10000, 10240, 2.0, 5,
                                          False), 16),
    # select-all rate with a 2-slot list: most lanes overflow
    "capl_overflow": (lambda: _single_args("random", 7000, 8192, 1.0, 7,
                                           False), 2),
    # a 3 kb homopolymer: syncless lanes, whole-block prefix passes
    "homopolymer_suffix": (lambda: _single_args("homopolymer", 7900,
                                                8192, 2.0, 9, False), 16),
    "homopolymer_prefix": (lambda: _single_args("homopolymer", 7900,
                                                8192, 2.0, 9, True), 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_triton_sweep_matches_xla_sweep(case):
    build, capl = CASES[case]
    args = build()
    want = _reference(args, capl)
    got = F._sweep_triton(*args, capl=capl, interpret=True)
    for f, (a, b) in enumerate(zip(want[0], got[0])):
        assert np.array_equal(np.asarray(a), np.asarray(b)), ("state", f)
    for i in range(1, 5):
        assert np.array_equal(np.asarray(want[i]), np.asarray(got[i])), i
    if case == "capl_overflow":
        assert int(jnp.max(want[1])) > capl
