"""The backend dispatch point and what hangs off it: engine choice per
platform, the comparator CLI's engine, the GPU resolve and walk paths
(run here with the Triton sweep in interpret mode), the fused
single-tile program, the compile-cache placement and the keyed native
library."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import supersampler_tpu
from supersampler_tpu import backend, native
from supersampler_tpu.cli import comparator as cli_comparator
from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops import field as F
from supersampler_tpu.ops import walker as WK
from supersampler_tpu.ops.minimizer import pack_2bit_np


@pytest.mark.parametrize("plat,want", [
    ("gpu", "gpu"), ("cpu", "cpu"), ("tpu", None), ("rocm", None),
    ("METAL", None)])
def test_engine_per_platform(monkeypatch, plat, want):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    if want is None:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            backend.engine()
    else:
        assert backend.engine() == want


@pytest.mark.parametrize("env,plat,want", [
    (None, "cpu", "device"), (None, "gpu", "device"),
    ("numpy", "gpu", "numpy"), ("device", "cpu", "device"),
    (None, "tpu", None)])
def test_pick_engine(monkeypatch, env, plat, want):
    """auto follows the backend JAX reports, not JAX_PLATFORMS, and an
    unsupported platform raises instead of quietly picking numpy."""
    if env is None:
        monkeypatch.delenv("SPSP_COMPARE_ENGINE", raising=False)
    else:
        monkeypatch.setenv("SPSP_COMPARE_ENGINE", env)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    if want is None:
        with pytest.raises(RuntimeError):
            cli_comparator.pick_engine()
    else:
        assert cli_comparator.pick_engine() == want


def _thr(s, k=31, m=11):
    thr = compute_threshold(k, m, s)
    return jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)


def _gpu_engine_interpreted(monkeypatch):
    """Route the field module's dispatch to the GPU branch with the
    Triton sweep interpreted on the CPU."""
    sweep = F._sweep_triton
    calls = []

    def interp(*a, **kw):
        calls.append(1)
        return sweep(*a, **kw, interpret=True)

    monkeypatch.setattr(F, "engine", lambda: "gpu")
    monkeypatch.setattr(F, "_sweep_triton", interp)
    return calls


@pytest.mark.parametrize("i,s,kind", [(0, 5.0, "random"),
                                      (1, 1.0, "random"),
                                      (2, 3.0, "homopolymer")])
def test_resolve_field_gpu_path_matches_cpu_path(monkeypatch, i, s, kind):
    """resolve_field with the GPU sweep == with the XLA sweep (each
    case and engine gets its own sel_cap, so each traces its own
    program)."""
    k, m, P, L = 31, 11, 8192, 7800
    rng = np.random.default_rng(21)
    codes = np.zeros(P, np.uint8)
    codes[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    if kind == "homopolymer":
        codes[2000:5000] = 1
    thi, tlo = _thr(s)
    t = jax.jit(F.scan_field_2d, static_argnums=(1, 2, 3, 5))(
        jnp.asarray(codes), k, m, P, jnp.int32(L), True)
    entry = F.field_entry_init(t, thi, tlo)
    cap_w, cap_g = 8193 + 4 * i, 8195 + 4 * i
    want = np.asarray(F.resolve_field(t, k, m, cap_w, entry, thi, tlo))
    calls = _gpu_engine_interpreted(monkeypatch)
    got = np.asarray(F.resolve_field(t, k, m, cap_g, entry, thi, tlo))
    assert calls, "the GPU branch did not run the Triton sweep"
    sw, cw, nw = F.parse_field_array(want, cap_w)
    sg, cg, ng = F.parse_field_array(got, cap_g)
    assert (sw, nw) == (sg, ng)
    assert np.array_equal(want[:F._HEAD], got[:F._HEAD])
    for a, b in zip(cw, cg):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_scan_resolve_batch_gpu_path_matches_cpu_path(monkeypatch):
    k, m, P_rec, B_n = 31, 11, 1024, 16
    rng = np.random.default_rng(5)
    lens = rng.integers(40, P_rec - 150, B_n).astype(np.int32)
    codes = np.zeros((B_n, P_rec), np.uint8)
    for b in range(B_n):
        codes[b, : lens[b]] = rng.integers(0, 4, lens[b], dtype=np.uint8)
    packed = jnp.asarray(np.stack([pack_2bit_np(c) for c in codes]))
    thi, tlo = _thr(2.0)
    want = np.asarray(F.scan_resolve_batch(packed, k, m, P_rec, 4096 + 1,
                                           jnp.asarray(lens), thi, tlo))
    calls = _gpu_engine_interpreted(monkeypatch)
    got = np.asarray(F.scan_resolve_batch(packed, k, m, P_rec, 4096 + 3,
                                          jnp.asarray(lens), thi, tlo))
    assert calls
    gw = F.parse_batched_array(want, 4096 + 1, B_n)
    gg = F.parse_batched_array(got, 4096 + 3, B_n)
    assert gw[:2] == gg[:2] and np.array_equal(gw[3], gg[3])
    for cw, cg in zip(gw[2], gg[2]):
        for a, b in zip(cw, cg):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("s", [10.0, 1.0])
def test_scan_resolve_single_matches_split_path(s):
    """The fused single-tile program (the GPU dispatch) == the CPU's
    split scan / entry / resolve dispatches, on the same halo'd slab."""
    k, m, own, extra = 31, 11, 2048, 512
    P = own + extra
    rng = np.random.default_rng(31)
    L = 2300
    c = np.zeros(128 + P, np.uint8)
    c[128 : 128 + L] = rng.integers(0, 4, L, dtype=np.uint8)
    slab = jnp.asarray(pack_2bit_np(c))
    thi, tlo = _thr(s)
    cap = 4096
    fused = np.asarray(F.scan_resolve_single(slab, k, m, P, cap,
                                             jnp.int32(L), thi, tlo))
    ft = jax.jit(F.scan_field_2d_packed, static_argnums=(1, 2, 3, 5))(
        slab[32:], k, m, P, jnp.int32(L), True)
    entry = F.field_entry_init(ft, thi, tlo)
    split = np.asarray(F.resolve_field(ft, k, m, cap, entry, thi, tlo))
    assert int(fused[0]) == 0 and int(fused[1]) > 0
    assert np.array_equal(fused, split)


def test_device_chain_gpu_walk_matches_pointer_doubling(monkeypatch):
    """On the GPU branch DeviceChain walks by doubling; its compact ==
    ops/chain.compact_chain (n_pad is fresh, so the walk retraces)."""
    from supersampler_tpu.ops.chain import compact_chain
    from tests.test_walker import _tables

    monkeypatch.setattr(WK, "engine", lambda: "gpu")
    t = _tables(3000, 2.0, 41)
    ref = compact_chain(t)
    got = WK.DeviceChain(t, n_pad=6 * WK._BP).compact()
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (nothing is set in code);
    otherwise the cache sits at build/jax_cache inside the checkout."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            supersampler_tpu.enable_compilation_cache()
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            supersampler_tpu.enable_compilation_cache()
            assert (jax.config.jax_compilation_cache_dir
                    == supersampler_tpu.CACHE_DIR)
            assert supersampler_tpu.CACHE_DIR.endswith(
                "build/jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_keyed_on_flags_and_cpu(monkeypatch):
    """Another CPU or other flags name another library, so a checkout
    copied to a new host builds its own instead of loading a stale
    one; the key is stable otherwise."""
    base = native.lib_path()
    assert base == native.lib_path()
    assert "/build/libspsp_native-" in base
    monkeypatch.setattr(native, "_host_cpu", lambda: "other-cpu")
    other_cpu = native.lib_path()
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-g"])
    other_flags = native.lib_path()
    assert len({base, other_cpu, other_flags}) == 3


def test_native_library_loads_from_keyed_path():
    lib = native.get_lib()
    assert lib is not None
    assert lib._name == native.lib_path()
