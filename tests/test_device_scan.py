"""The device scan pipeline is bit-identical to the scalar oracle."""

import gzip
import json
import os

import numpy as np
import pytest

from supersampler_tpu.oracle import OracleSubsampler
from supersampler_tpu.sketch.pipeline import TpuSubsampler


CONFIGS = [
    (31, 11, "10", 1),
    (31, 11, "1000", 1),
    (21, 7, "5", 1),
    (15, 5, "2", 1),
    (63, 15, "10", 1),
    (31, 11, "1", 2),
]


@pytest.mark.parametrize("k,m,s,a", CONFIGS)
def test_device_matches_oracle_simple(datadir, k, m, s, a):
    sv = float(np.float32(s))
    o = OracleSubsampler(k=k, m=m, s=sv, abundance=a)
    t = TpuSubsampler(k=k, m=m, s=sv, abundance=a)
    want = o.sketch_file(datadir["simple"])
    got = t.sketch_file(datadir["simple"])
    assert got == want, f"k={k} m={m} s={s}"
    assert t.total_kmer_number == o.total_kmer_number
    assert t.total_superkmer_number == o.total_superkmer_number
    assert t.selected_kmer_number == o.selected_kmer_number
    assert t.nb_mmer_selected == o.nb_mmer_selected


@pytest.mark.parametrize("dataset", ["edge", "repeat", "big"])
def test_device_matches_oracle_datasets(datadir, dataset):
    o = OracleSubsampler(k=31, m=11, s=10.0)
    t = TpuSubsampler(k=31, m=11, s=10.0)
    want = o.sketch_file(datadir[dataset])
    got = t.sketch_file(datadir[dataset])
    assert got == want


def test_device_matches_goldens(datadir, goldendir):
    """End-to-end: the device pipeline reproduces the reference binaries."""
    with open(os.path.join(goldendir, "meta.json")) as f:
        meta = json.load(f)
    for cfg in meta["sketches"][:6]:
        golden = gzip.open(os.path.join(goldendir, cfg["file"]), "rb").read()
        t = TpuSubsampler(k=cfg["k"], m=cfg["m"],
                          s=float(np.float32(cfg["s"])), abundance=cfg["a"])
        got = t.sketch_file(datadir[cfg["dataset"]])
        assert got == golden, f"golden mismatch {cfg}"
