"""Many-short-record (reads/metagenome-style) sketching parity.

The batched short-record path of TpuSubsampler.sketch_file (per-bucket
scan_resolve_batch dispatches) must produce byte-identical sketches to
the scalar oracle — including stats counters — for corpora of hundreds
of small records with Ns, lowercase, sub-k records and mixed sizes
(reference parse loop semantics, SubSampler.cpp:334-347).
"""

import io
import random

import pytest

from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu.sketch.pipeline import TpuSubsampler


def _write_reads(path, rng, n, lo, hi, messy=True):
    with open(path, "w") as f:
        for i in range(n):
            L = rng.randint(lo, hi)
            s = "".join(rng.choice("ACGT") for _ in range(L))
            if messy and i % 7 == 0 and L > 30:
                s = s[:10] + "NNnN" + s[10:20].lower() + s[20:]
            if messy and i % 23 == 5:
                s = s[:5]                  # sub-k record (ignored)
            f.write(f">r{i}\n")
            for j in range(0, len(s), 61):
                f.write(s[j : j + 61] + "\n")


@pytest.mark.parametrize("n,lo,hi,s", [
    (300, 120, 400, 3.0),      # short reads, one bucket
    (120, 200, 3000, 6.0),     # mixed buckets
    (64, 40, 150, 1.0),        # select-all tiny reads
])
def test_reads_corpus_matches_oracle(tmp_path, n, lo, hi, s):
    fa = tmp_path / "reads.fa"
    _write_reads(str(fa), random.Random(n * 31 + lo), n, lo, hi)
    oracle = OracleSubsampler(k=31, m=11, s=s)
    oracle.log = io.StringIO()
    want = oracle.sketch_file(str(fa))
    dev = TpuSubsampler(k=31, m=11, s=s)
    dev.log = io.StringIO()
    got = dev.sketch_file(str(fa))
    assert got == want
    # stats counters are part of the parity contract (print_stat,
    # reference SubSampler.cpp:633-665)
    for attr in ("read_kmer", "total_kmer_number",
                 "total_superkmer_number", "selected_kmer_number",
                 "selected_superkmer_number", "nb_mmer_selected",
                 "count_maximal_skmer"):
        assert getattr(dev, attr) == getattr(oracle, attr), attr


def test_mixed_cap_medium_batch(tmp_path):
    """Two medium contigs of different padded sizes under select_all
    produce different per-record compact-array lengths; the fetch
    batch must split instead of stacking mismatched shapes
    (regression: jnp.stack crash, r4 review)."""
    fa = tmp_path / "contigs.fa"
    rng = random.Random(9)
    with open(fa, "w") as f:
        for i, L in enumerate((70000, 140000)):
            f.write(f">c{i}\n"
                    + "".join(rng.choice("ACGT") for _ in range(L))
                    + "\n")
    oracle = OracleSubsampler(k=31, m=11, s=1.0)
    want = oracle.sketch_file(str(fa))
    dev = TpuSubsampler(k=31, m=11, s=1.0)
    got = dev.sketch_file(str(fa))
    assert got == want


def test_legacy_engine_knob_respected(tmp_path):
    """scan_engine='legacy' must route even short records through the
    walker path (regression: the short batch ignored the knob)."""
    fa = tmp_path / "r.fa"
    _write_reads(str(fa), random.Random(3), 40, 100, 400, messy=False)

    class LegacySub(TpuSubsampler):
        scan_engine = "legacy"

    oracle = OracleSubsampler(k=31, m=11, s=2.0)
    want = oracle.sketch_file(str(fa))
    dev = LegacySub(k=31, m=11, s=2.0)
    got = dev.sketch_file(str(fa))
    assert got == want


def test_reads_small_batch_flush(tmp_path):
    """Fewer records than a batch: the tail flush must cover them."""
    fa = tmp_path / "tiny.fa"
    _write_reads(str(fa), random.Random(1), 3, 100, 200, messy=False)
    oracle = OracleSubsampler(k=21, m=9, s=2.0)
    want = oracle.sketch_file(str(fa))
    dev = TpuSubsampler(k=21, m=9, s=2.0)
    got = dev.sketch_file(str(fa))
    assert got == want
