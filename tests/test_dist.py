"""Multi-host orchestration (parallel/dist.py): single-process
semantics, shard ownership, and a simulated 2-host decode-shard +
gather + score that must equal the single-host comparator."""

import gzip
import json
import os

import numpy as np
import pytest

from supersampler_tpu.compare.merge import TpuComparator
from supersampler_tpu.parallel import dist


def test_owned_shard_partitions():
    items = list(range(10))
    shards = [dist.owned_shard(items, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert shards[0] == [0, 3, 6, 9]


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    dist.initialize()          # must not raise nor init anything
    assert dist.process_info() == (0, 1)


def test_compare_distributed_single_process(goldendir):
    with open(os.path.join(goldendir, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    files = [os.path.join(goldendir, f_) for f_ in cfg["files"]]
    comp = dist.compare_all_vs_all_distributed(files)
    ref = TpuComparator(engine="numpy")
    ref.files_names = list(files)
    ref.compare_sketches(len(files))
    assert comp.score_A == ref.score_A
    assert comp.nb_kmer_seen_infile == ref.nb_kmer_seen_infile


def test_real_two_process_distributed_compare(goldendir, tmp_path):
    """Spawn TWO actual jax.distributed processes (localhost
    coordinator, CPU backend) running compare_all_vs_all_distributed
    end-to-end — the real process_allgather branch with unequal
    per-host pair counts — and assert process 0's CSVs equal the
    single-host engine's."""
    import socket
    import subprocess
    import sys

    with open(os.path.join(goldendir, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    files = [os.path.join(goldendir, f_) for f_ in cfg["files"]]
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(files) + "\n")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "dist_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)        # one device per process
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i), "2", str(fof),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]

    ref = TpuComparator(engine="numpy")
    ref.files_names = list(files)
    ref.compare_sketches(len(files))
    assert (tmp_path / "containment.csv").read_text() \
        == ref.containment_csv()
    assert (tmp_path / "jaccard.csv").read_text() == ref.jaccard_csv()


def test_simulated_two_host_shard_gather_score(goldendir):
    """Replicate the multi-host flow by hand: two 'hosts' decode
    disjoint strided file shards, pair arrays concatenate (the
    all-gather), one comparator scores — must equal single-host."""
    from supersampler_tpu.compare.reader import decode_sketch_pairs

    with open(os.path.join(goldendir, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    files = [os.path.join(goldendir, f_) for f_ in cfg["files"]]

    parts = []
    k = m = 0
    for host in range(2):
        for f, path in dist.owned_shard(list(enumerate(files)), host, 2):
            mins, his, los, k, m, _ = decode_sketch_pairs(path)
            parts.append(np.stack([
                mins, his, los, np.full(mins.size, f, np.uint64)]))
    allp = np.concatenate(parts, axis=1)

    comp = TpuComparator(engine="device")
    comp.files_names = list(files)
    comp.nb_files = len(files)
    comp.query_size = len(files)
    comp.k, comp.m = k, m
    fids = allp[3].astype(np.int64)
    comp.nb_kmer_seen_infile = np.bincount(
        fids, minlength=len(files)).tolist()
    comp._score_pairs(allp[0], allp[1], allp[2], fids, len(files))

    ref = TpuComparator(engine="numpy")
    ref.files_names = list(files)
    ref.compare_sketches(len(files))
    assert comp.score_A == ref.score_A
    assert comp.nb_kmer_seen_infile == ref.nb_kmer_seen_infile
    # CSV parity end-to-end
    assert comp.containment_csv() == ref.containment_csv()
    assert comp.jaccard_csv() == ref.jaccard_csv()
