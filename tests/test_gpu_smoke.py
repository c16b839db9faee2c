"""On-card smoke set: `make test-gpu` (SPSP_TEST_PLATFORM=gpu pytest -m gpu).

Skipped on the CPU suite (the `gpu` fixture decides when each test
runs). On an NVIDIA GPU these run the compiled Triton sweep kernel and
the GPU chain walk against their plain references, and the whole
pipeline against the goldens — the guard against miscompiles that
interpret-mode testing cannot catch.
"""

import gzip
import json
import os

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def test_golden_sketches_on_gpu(datadir, goldendir):
    """Every golden sketch config through the default (field) engine."""
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    with open(os.path.join(goldendir, "meta.json")) as f:
        meta = json.load(f)["sketches"]
    for cfg in meta:
        ss = TpuSubsampler(k=cfg["k"], m=cfg["m"],
                           s=float(np.float32(cfg["s"])),
                           abundance=cfg["a"])
        raw = ss.sketch_file(datadir[cfg["dataset"]])
        want = gzip.open(os.path.join(goldendir, cfg["file"]), "rb").read()
        assert raw == want, cfg["file"]


def test_golden_compare_on_gpu(goldendir):
    """Device comparator engine vs golden CSVs on the card."""
    from supersampler_tpu.compare.merge import TpuComparator

    with open(os.path.join(goldendir, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    comp = TpuComparator(engine="device")
    comp.files_names = [os.path.join(goldendir, f_) for f_ in cfg["files"]]
    comp.compare_sketches(len(cfg["files"]))
    for kind, csv in (("containment", comp.containment_csv()),
                      ("jaccard", comp.jaccard_csv())):
        want = gzip.open(os.path.join(
            goldendir, f"allvsall_{kind}.csv.gz"), "rt").read()
        # golden CSVs carry bare basenames; ours carry goldendir paths
        assert csv.split("\n", 1)[1] == want.split("\n", 1)[1], kind


def test_triton_sweep_compiled_matches_xla_sweep():
    """The compiled Triton sweep == _sweep + _lists_from_dense, on
    every case of the interpret-mode suite (tests/test_sweep.py)."""
    from supersampler_tpu.ops import field as F
    from tests.test_sweep import CASES, _reference

    for case, (build, capl) in sorted(CASES.items()):
        args = build()
        want = _reference(args, capl)
        got = F._sweep_triton(*args, capl=capl)
        for a, b in zip(want[0], got[0]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), case
        for i in range(1, 5):
            assert np.array_equal(np.asarray(want[i]),
                                  np.asarray(got[i])), (case, i)


def test_doubling_walk_compiled_matches_serial_walk():
    """walk_doubling (the GPU walk) == walk_xla on the card."""
    import jax.numpy as jnp

    from supersampler_tpu.ops.walker import (_BP, _init5_from_tables,
                                             pack_succ, walk_doubling,
                                             walk_xla)
    from tests.test_walker import _tables

    t = _tables(7777, 3.0, 5)
    n = int(t.nxt_pos_a.shape[0])
    packed = pack_succ(t, ((n + _BP - 1) // _BP) * _BP)
    init5 = _init5_from_tables(t)
    want = walk_xla(packed, init5)
    got = walk_doubling(packed, init5)
    assert int(jnp.sum(want[3])) > 0
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_batched_short_records_on_gpu(tmp_path):
    """Batched short-record engine (per-lane position frames in the
    compiled sweep) vs the oracle on the card."""
    import io
    import random

    from supersampler_tpu.oracle.subsampler import OracleSubsampler
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    rng = random.Random(2026)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as f:
        for i in range(150):
            L = rng.randint(100, 2000)
            s = "".join(rng.choice("ACGT") for _ in range(L))
            f.write(f">r{i}\n{s}\n")
    for s_rate in (1.0, 4.0):
        oracle = OracleSubsampler(k=31, m=11, s=s_rate)
        oracle.log = io.StringIO()
        want = oracle.sketch_file(str(fa))
        ss = TpuSubsampler(k=31, m=11, s=s_rate)
        ss.log = io.StringIO()
        assert ss.sketch_file(str(fa)) == want, s_rate


def test_tile_fallback_on_gpu():
    """Tile-granular walker fallback (field->walker->field state
    conversion) byte-exact on the card."""
    from supersampler_tpu.oracle.subsampler import OracleSubsampler
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    OWN = 1 << 18

    class SmallTiles(TpuSubsampler):
        scan_engine = "field"
        _tile_own = OWN
        _tile_extra = 512

    rng = np.random.default_rng(7)
    mk = lambda n: "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    ref = mk(OWN + 5000) + "A" * 4000 + mk(OWN - 5000)
    ss = SmallTiles(k=31, m=11, s=3.0)
    dc = ss._launch_scan(ref.encode())
    ss._finish_scan(ref, dc)
    assert dc.fallback_tiles and len(dc.fallback_tiles) < dc._n_tiles
    oracle = OracleSubsampler(k=31, m=11, s=3.0)
    oracle.scan_sequence(ref)
    assert ss.serialize() == oracle.serialize()
