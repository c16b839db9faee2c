"""Plain-text k-mer dump (cli/kmer_dump.py) parity.

The dump is the live equivalent of the reference's commented
kmers_reconstruct hook (SubSampler.h:41-42, SubSampler.cpp:591-593)
and the content-level parity oracle: the k-mer SET decoded from our
sketch must equal the set decoded from the reference binary's sketch
of the same input, modulo the strCompressor quirk — the reference's
uninitialized accumulator can corrupt the FIRST nucleotide of a
bucket's maximal-blob, which surfaces here as a k-mer differing only
in its first base (possibly after a canonical-strand flip, when the
corrupted first base changes which strand is smaller).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

_RCMAP = str.maketrans("ACGT", "TGCA")


def _rc(s: str) -> str:
    return s.translate(_RCMAP)[::-1]


def _end_diff_only(x: str, y: str) -> bool:
    """True when x and y differ at exactly one position that is an END
    of the k-mer, in either orientation — the strCompressor quirk
    corrupts the first base of a blob in STORED orientation, which
    after canonical re-orientation surfaces at position 0 or k-1."""
    for cand in (y, _rc(y)):
        d = [i for i in range(len(x)) if x[i] != cand[i]]
        if len(d) == 1 and d[0] in (0, len(x) - 1):
            return True
    return False


def assert_kmer_sets_quirk_equal(set_a, set_b):
    """Equal sets, allowing single-end-base pairs (either strand) —
    the strCompressor quirk's exact footprint."""
    da, db = set_a - set_b, set_b - set_a
    assert len(da) == len(db), (len(da), len(db))
    unmatched_b = set(db)
    for x in da:
        hit = next((y for y in unmatched_b if _end_diff_only(x, y)),
                   None)
        assert hit is not None, f"non-quirk k-mer difference: {x}"
        unmatched_b.discard(hit)
    assert not unmatched_b


REFBIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".refbin", "sub_sampler")


@pytest.mark.skipif(not os.path.exists(REFBIN),
                    reason="reference binary not built")
def test_kmer_dump_set_parity_vs_reference(tmp_path, monkeypatch):
    from supersampler_tpu.cli.kmer_dump import dump
    from supersampler_tpu.io.gzip_exact import write_gzip_exact
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8899)
    nuc = np.frombuffer(b"ACGT", np.uint8)
    L = 1_000_000
    with open("g.fa", "wb") as f:
        f.write(b">g\n"
                + nuc[rng.integers(0, 4, L, dtype=np.uint8)].tobytes()
                + b"\n")
    subprocess.run(
        [REFBIN, "-i", "g.fa", "-k", "31", "-m", "11", "-s", "50",
         "-p", "ref_", "-a", "1"], check=True, capture_output=True)
    ss = TpuSubsampler(k=31, m=11, s=float(np.float32(50)))
    write_gzip_exact("ours_g.gz", ss.sketch_file("g.fa"), 9)
    a, b = io.StringIO(), io.StringIO()
    n_ref = dump("ref_g.gz", a)
    n_ours = dump("ours_g.gz", b)
    assert n_ref == n_ours
    set_a = set(a.getvalue().split())
    set_b = set(b.getvalue().split())
    assert len(set_a) == n_ref and len(set_b) == n_ours  # all distinct
    assert_kmer_sets_quirk_equal(set_a, set_b)


def test_kmer_dump_cli_roundtrip(tmp_path, monkeypatch):
    """CLI surface: file output equals stdout dump; k-mers are k long
    and canonical-present in the input."""
    from contextlib import redirect_stdout

    from supersampler_tpu.cli import kmer_dump
    from supersampler_tpu.io.gzip_exact import write_gzip_exact
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    nuc = np.frombuffer(b"ACGT", np.uint8)
    g = nuc[rng.integers(0, 4, 40000, dtype=np.uint8)].tobytes()
    with open("g.fa", "wb") as f:
        f.write(b">g\n" + g + b"\n")
    ss = TpuSubsampler(k=21, m=9, s=5.0)
    write_gzip_exact("s.gz", ss.sketch_file("g.fa"), 9)
    rc = kmer_dump.main(["s.gz", "out.txt"])
    assert rc == 0
    lines = open("out.txt").read().split()
    buf = io.StringIO()
    with redirect_stdout(buf):
        kmer_dump.main(["s.gz"])
    assert buf.getvalue().split() == lines
    gs = g.decode()
    assert lines and all(len(x) == 21 for x in lines)
    for x in lines[:: max(1, len(lines) // 25)]:
        assert x in gs or _rc(x) in gs
