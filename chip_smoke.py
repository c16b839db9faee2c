#!/usr/bin/env python3
"""The sketcher and comparator end to end on one NVIDIA GPU.

    python chip_smoke.py                  # phases A-C on one card
    python chip_smoke.py --four-cards     # phase D only, on four cards

Every phase drives the entry points a user calls and compares each
result with the repo's plain reference, byte for byte (all outputs are
integers or text, so there is no tolerance):

  A. Goldens: every sketch config of tests/golden/meta.json through the
     sub_sampler CLI, and the all-vs-all and query CSVs through the
     comparator CLI, against tests/golden/. The tests marked `gpu` run
     first, in a child process that exits before this one opens the
     card.
  B. Kernels at real widths: the Triton field sweep against the XLA
     sweep (_sweep + _lists_from_dense) on a 4 Mbp tile (16384 lanes),
     suffix and prefix pass, and inside a whole resolve and a
     4096-record batch; the GPU chain walk against ops/chain's pointer
     doubling on a repeat-rich 4 Mbp tile; the s8 presence dot against
     numpy at N=100. Each with its compile and per-call time.
  C. The main path at a size users run: 10 genomes of 5 Mbp in two
     families (mutation rates 0.1%-10%, some gzipped; two 4 Mbp tiles
     each, so the on-device carry runs), one 4 Mbp repeat-rich record
     (homopolymer and tandem tracts: it must take the walker fallback)
     and 50,000 150-bp reads at 5x of a 1.5 Mbp genome with 1% errors
     at -a 2 (the batched engine). sub_sampler -f/-i, then comparator
     all-vs-all and -q with 2 queries. Sketches must equal the Python
     oracle's (run in CPU-only worker processes that never open the
     card), CSVs the numpy engine's.
  D. (--four-cards) the sharded field engine on a 4-GPU mesh against
     one card over 4 x 4096 records of 1-16 kb, and the mesh
     comparator against the numpy engine over 100 sketches.

All inputs are generated from fixed seeds under build/chip_smoke/.
The script exits non-zero, with no result line, if JAX finds no GPU or
any phase fails. The card's name and power limit (nvidia-smi) come
before the last line, which is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

--rehearse-cpu runs the same phases at a tiny size on the CPU (the
Triton sweep interpreted), for checking the script without a card; it
ends with exit code 3 and no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
K, M = 31, 11

FULL = dict(genome=5_000_000, n_fam=2, fam_size=5, repeat=4_000_000,
            reads=50_000, read_genome=1_500_000, tile_lanes=16384,
            batch=4096, dot_rows=1 << 16, dot_n=100, d_batch=4096,
            d_genomes=100, d_genome=200_000)
TINY = dict(genome=60_000, n_fam=2, fam_size=2, repeat=40_000,
            reads=2_000, read_genome=30_000, tile_lanes=64, batch=64,
            dot_rows=4096, dot_n=20, d_batch=16, d_genomes=8,
            d_genome=20_000)


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def log(*a):
    print(*a, flush=True)


def card_lines():
    """nvidia-smi's name and power limit per card; None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines if out.returncode == 0 and lines else None


# ---------------------------------------------------------------- data

NUC = np.frombuffer(b"ACGT", np.uint8)


def write_fasta(path, records, gz=False, width=80):
    """records: [(name, codes uint8 0..3)] -> wrapped FASTA."""
    f = gzip.open(path, "wb", compresslevel=1) if gz else open(path, "wb")
    with f:
        for name, codes in records:
            f.write(b">" + name.encode() + b"\n")
            seq = NUC[codes]
            n = seq.size
            rows = -(-n // width)
            grid = np.full((rows, width + 1), ord("\n"), np.uint8)
            flat = np.zeros(rows * width, np.uint8)
            flat[:n] = seq
            grid[:, :width] = flat.reshape(rows, width)
            body = grid.reshape(-1)
            last = n - (rows - 1) * width
            f.write(body[: (rows - 1) * (width + 1) + last].tobytes())
            f.write(b"\n")


def mutate(codes, rate, rng):
    hit = rng.random(codes.size) < rate
    out = codes.copy()
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()),
                                        dtype=np.uint8)) % 4
    return out


def repeat_rich(n, rng):
    """Random sequence with homopolymer and tandem-repeat tracts; the
    long homopolymers leave the sync decomposition without strict
    minima, which sends the record to the walker fallback."""
    c = rng.integers(0, 4, n, dtype=np.uint8)
    for _ in range(max(2, n // 160_000)):
        a = int(rng.integers(0, n - 8000))
        c[a : a + int(rng.integers(2000, 8000))] = rng.integers(0, 4)
    for _ in range(max(2, n // 100_000)):
        unit = rng.integers(0, 4, int(rng.integers(2, 61)),
                            dtype=np.uint8)
        ln = int(rng.integers(1000, 10_000))
        a = int(rng.integers(0, n - ln))
        c[a : a + ln] = np.tile(unit, ln // unit.size + 1)[:ln]
    return c


def make_reads(n_reads, glen, rng):
    g = rng.integers(0, 4, glen, dtype=np.uint8)
    starts = rng.integers(0, glen - 150, n_reads)
    reads = g[starts[:, None] + np.arange(150)[None, :]]
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]            # A<->T, C<->G
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) % 4
    return reads


def make_corpus(d, sz):
    """Phase C inputs: returns (genome paths, repeat path, reads path)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(2026)
    rates = [0.001, 0.005, 0.01, 0.05, 0.1][: sz["fam_size"]]
    genomes = []
    for f in range(sz["n_fam"]):
        base = rng.integers(0, 4, sz["genome"], dtype=np.uint8)
        for i, r in enumerate(rates):
            gz = (f * len(rates) + i) % 3 == 2
            p = os.path.join(d, f"fam{f}_g{i}.fa" + (".gz" if gz else ""))
            write_fasta(p, [(f"fam{f}_g{i}", mutate(base, r, rng))], gz)
            genomes.append(p)
    rep = os.path.join(d, "repeats.fa")
    write_fasta(rep, [("repeats", repeat_rich(sz["repeat"], rng))])
    reads = os.path.join(d, "reads.fa")
    write_fasta(reads, [(f"read{i}", r) for i, r in enumerate(
        make_reads(sz["reads"], sz["read_genome"], rng))])
    return genomes, rep, reads


def _cpu_worker():
    os.environ["JAX_PLATFORMS"] = "cpu"


def oracle_sketch(path, abundance):
    """Runs in a CPU-only worker: the oracle's sketch bytes."""
    from supersampler_tpu.oracle.subsampler import OracleSubsampler

    o = OracleSubsampler(k=K, m=M, s=float(np.float32(1000)),
                         abundance=abundance)
    o.log = io.StringIO()
    return o.sketch_file(path)


# ---------------------------------------------------------------- helpers

def quiet(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


def gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def timed(fn, *args, reps=5):
    """(result, first-call seconds incl. compile, median steady s)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, first, statistics.median(ts)


def same(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def report(card, what, first, per):
    log(f"  {what}: first call {first:.3f} s (compile + run), "
        f"{per * 1e3:.3f} ms per call [{card}]")


# ---------------------------------------------------------------- phases

def run_gpu_tests():
    """The tests marked `gpu`, in a child that exits before this
    process touches the card."""
    env = dict(os.environ, SPSP_TEST_PLATFORM="gpu")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", "tests/test_gpu_smoke.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"A. tests marked gpu: {tail}")
    check(r.returncode == 0 and "passed" in tail and "skipped" not in tail
          and "failed" not in tail,
          "gpu tests: " + (r.stdout + r.stderr)[-3000:])


def phase_a(card):
    from supersampler_tpu.cli import comparator as cli_cmp
    from supersampler_tpu.cli import sub_sampler as cli_sub
    from tests.make_data import make_all

    gold = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    d = os.path.join(WORK, "a")
    os.makedirs(d, exist_ok=True)
    data = make_all(os.path.join(d, "data"))
    os.chdir(d)
    t0 = time.perf_counter()
    for i, cfg in enumerate(meta["sketches"]):
        pre = f"a{i}_"
        rc, _ = quiet(cli_sub.main, [
            "-i", data[cfg["dataset"]], "-k", str(cfg["k"]), "-m",
            str(cfg["m"]), "-s", cfg["s"], "-a", str(cfg["a"]), "-p", pre])
        stem = os.path.basename(data[cfg["dataset"]]).split(".")[0]
        check(rc == 0 and gunzip(pre + stem + ".gz")
              == gunzip(os.path.join(gold, cfg["file"])),
              f"golden sketch {cfg['file']}")
    cmp = meta["compare"]
    for f_ in cmp["files"]:
        if not os.path.exists(f_):
            os.symlink(os.path.join(gold, f_), f_)
    with open("all.txt", "w") as f:
        f.write("\n".join(cmp["files"]) + "\n")
    with open("q.txt", "w") as f:
        f.write("\n".join(cmp["query_files"]) + "\n")
    with open("bank.txt", "w") as f:
        f.write("\n".join(cmp["bank_files"]) + "\n")
    quiet(cli_cmp.main, ["-f", "all.txt", "-o", "avsa"])
    quiet(cli_cmp.main, ["-q", "q.txt", "-f", "bank.txt", "-p",
                         str(cmp["query_precision"]), "-m",
                         str(cmp["query_min_threshold"]), "-o", "qry"])
    for kind in ("containment", "jaccard"):
        with open(f"avsa_{kind}.csv.gz", "rb") as a, open(os.path.join(
                gold, f"allvsall_{kind}.csv.gz"), "rb") as b:
            check(a.read() == b.read(), f"golden all-vs-all {kind}")
        check(gunzip(f"qry_{kind}.csv.gz")
              == gunzip(os.path.join(gold, f"query_{kind}.csv.gz")),
              f"golden query {kind}")
    log(f"A. goldens: {len(meta['sketches'])} sketch configs, all-vs-all "
        f"and query CSVs byte-equal "
        f"({time.perf_counter() - t0:.1f} s incl. compile) [{card}]")


def phase_b(card, sz, interpret):
    import jax
    import jax.numpy as jnp

    from supersampler_tpu.core.scalar import compute_threshold
    from supersampler_tpu.ops import field as F
    from supersampler_tpu.ops import walker as WK
    from supersampler_tpu.ops.chain import compact_chain
    from supersampler_tpu.ops.minimizer import pack_2bit_np, scan_tables_2d
    from supersampler_tpu.parallel.compare_dist import _accumulate
    from tests.test_sweep import _reference, _single_args

    lanes = sz["tile_lanes"]
    P = lanes * F._B
    log(f"B. kernels at {lanes} lanes ({P} positions per tile)")

    # -- the sweep alone, suffix and prefix pass
    for prefix in (False, True):
        args = _single_args("random", P - 700, P, 1000.0, 1, prefix)
        (tT, j0, li, W, n, st0, s_, e_, a_, force, thi, tlo) = args
        capl = 16
        ref = jax.jit(lambda *x: _reference(
            (x[0], x[1], x[2], W, n, x[3], x[4], x[5], x[6], force,
             x[7], x[8]), capl))
        tri = jax.jit(lambda *x: F._sweep_triton(
            x[0], x[1], x[2], W, n, x[3], x[4], x[5], x[6], force, x[7],
            x[8], capl, interpret=interpret))
        dyn = (tT, j0, li, st0, s_, e_, a_, thi, tlo)
        want, f_x, t_x = timed(ref, *dyn)
        got, f_t, t_t = timed(tri, *dyn)
        check(same(want[0], got[0]) and same(want[1:], got[1:]),
              f"sweep parity (prefix={prefix})")
        name = "prefix" if prefix else "suffix (force_entry)"
        report(card, f"Triton sweep, {name} pass", f_t, t_t)
        report(card, f"XLA sweep + lists, {name} pass", f_x, t_x)

    # -- whole resolve of one tile, GPU sweep vs XLA sweep; the scan
    thr = compute_threshold(K, M, 1000.0)
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)
    rng = np.random.default_rng(3)
    L = P - 700
    c = np.zeros(128 + P + 512, np.uint8)
    c[128 : 128 + L] = rng.integers(0, 4, L, dtype=np.uint8)
    slab = jax.device_put(pack_2bit_np(c))
    scan = jax.jit(F.scan_field_2d_packed, static_argnums=(1, 2, 3, 5))
    t, f_s, t_s = timed(scan, slab[32:], K, M, P + 512, jnp.int32(L),
                        True)
    report(card, "XLA field scan per tile", f_s, t_s)
    entry = F.field_entry_init(t, thi, tlo)
    cap = 8192
    res = lambda c_: F.resolve_field(t, K, M, c_, entry, thi, tlo)
    gpu_arr, f_g, t_g = timed(res, cap)
    with engine_as(F, "cpu"):
        xla_arr, f_x, t_x = timed(res, cap + 1)
    a1, a2 = np.asarray(gpu_arr), np.asarray(xla_arr)
    check(a1[0] == 0 and np.array_equal(a1[: F._HEAD], a2[: F._HEAD])
          and same(F.parse_field_array(a1, cap)[1],
                   F.parse_field_array(a2, cap + 1)[1]),
          "resolve parity, GPU vs XLA sweep")
    report(card, "resolve_field with the Triton sweep", f_g, t_g)
    report(card, "resolve_field with the XLA sweep", f_x, t_x)

    # -- a record batch through the batched engine
    B_n, P_rec = sz["batch"], 1024
    lens = rng.integers(150, 900, B_n).astype(np.int32)
    codes = rng.integers(0, 4, (B_n, P_rec), dtype=np.uint8)
    codes[np.arange(P_rec)[None, :] >= lens[:, None]] = 0
    packed = jax.device_put(np.stack([pack_2bit_np(r) for r in codes]))
    lens_d = jax.device_put(lens)
    bcap = 1 << 17
    bat = lambda c_: F.scan_resolve_batch(packed, K, M, P_rec, c_,
                                          lens_d, thi, tlo)
    b1, f_g, t_g = timed(bat, bcap)
    with engine_as(F, "cpu"):
        b2, f_x, t_x = timed(bat, bcap + 1)
    p1 = F.parse_batched_array(np.asarray(b1), bcap, B_n)
    p2 = F.parse_batched_array(np.asarray(b2), bcap + 1, B_n)
    check(p1[0] == 0 and p1[2] is not None and p1[:2] == p2[:2]
          and np.array_equal(p1[3], p2[3])
          and all(same(x, y) for x, y in zip(p1[2], p2[2])),
          "batched parity, GPU vs XLA sweep")
    report(card, f"scan_resolve_batch {B_n} records, Triton sweep",
           f_g, t_g)
    report(card, f"scan_resolve_batch {B_n} records, XLA sweep", f_x, t_x)

    # -- the chain walk on a repeat-rich tile
    rc_codes = np.zeros(P, np.uint8)
    rc_codes[: P - 700] = repeat_rich(P - 700, np.random.default_rng(9))
    thr_w = compute_threshold(K, M, 20.0)      # a denser selection
    tabs = jax.jit(scan_tables_2d, static_argnums=(1, 2, 3))(
        jnp.asarray(rc_codes), K, M, P, jnp.int32(P - 700),
        _u64(jnp.uint32(thr_w >> 32), jnp.uint32(thr_w & 0xFFFFFFFF)))
    n_pad = P
    packed_w = WK.pack_succ(tabs, n_pad)
    init5 = WK._init5_from_tables(tabs)
    wd = jax.jit(WK.walk_doubling)
    wx = jax.jit(WK.walk_xla)
    got_w, f_d, t_d = timed(wd, packed_w, init5)
    want_w, f_w, t_w = timed(wx, packed_w, init5, reps=1)
    check(same(want_w, got_w), "walk_doubling == walk_xla")
    t0 = time.perf_counter()
    oracle = compact_chain(tabs)
    f_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    compact_chain(tabs)
    t_c = time.perf_counter() - t0
    got = WK.DeviceChain(tabs, n_pad=n_pad).compact()
    check(same(oracle, got), "GPU walk == compact_chain")
    log(f"  repeat-rich tile: {int(np.asarray(got_w[4])[0])} events, "
        f"{int(np.asarray(got_w[3])[0])} selected boundaries")
    report(card, "walk_doubling (the GPU walk)", f_d, t_d)
    report(card, "walk_xla (while_loop walk)", f_w, t_w)
    report(card, "compact_chain (pointer doubling + host fetch)", f_c, t_c)

    # -- the comparator's presence dot
    n = sz["dot_n"]
    blk = (np.random.default_rng(4).random((sz["dot_rows"], n)) < 0.3
           ).astype(np.int8)
    tot0 = jnp.zeros((n, n), jnp.int32)
    dev, f_p, t_p = timed(_accumulate, tot0, jnp.asarray(blk))
    want = blk.T.astype(np.int64) @ blk.astype(np.int64)
    check(np.array_equal(np.asarray(dev).astype(np.int64), want),
          "presence dot == numpy")
    report(card, f"presence dot ({sz['dot_rows']} x {n} int8)", f_p, t_p)


class engine_as:
    """Point a module's backend dispatch at another engine (traces made
    inside see it; callers pass fresh static args to retrace)."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name

    def __enter__(self):
        self.old = self.mod.engine
        self.mod.engine = lambda: self.name

    def __exit__(self, *exc):
        self.mod.engine = self.old


def _u64(hi, lo):
    from supersampler_tpu.ops import u64 as U

    return U.U64(hi, lo)


def phase_c(card, corpus, oracle_futs):
    from supersampler_tpu.cli import comparator as cli_cmp
    from supersampler_tpu.cli import sub_sampler as cli_sub
    from supersampler_tpu.compare.merge import TpuComparator
    from supersampler_tpu.ops import walker as WK

    genomes, rep, reads = corpus
    d = os.path.dirname(rep)
    os.chdir(d)
    with open("fof.txt", "w") as f:
        f.write("\n".join(genomes + [rep]) + "\n")
    walks = []
    walk_jit = WK._walk_jit

    def counting(*a):
        walks.append(1)
        return walk_jit(*a)

    WK._walk_jit = counting
    try:
        t0 = time.perf_counter()
        rc1, _ = quiet(cli_sub.main, ["-f", "fof.txt", "-k", str(K), "-m",
                                      str(M), "-s", "1000", "-a", "1",
                                      "-p", "c_"])
        t_fof = time.perf_counter() - t0
    finally:
        WK._walk_jit = walk_jit
    t0 = time.perf_counter()
    rc2, _ = quiet(cli_sub.main, ["-i", reads, "-k", str(K), "-m", str(M),
                                  "-s", "1000", "-a", "2", "-p", "c_"])
    t_reads = time.perf_counter() - t0
    check(rc1 == 0 and rc2 == 0, "sub_sampler CLI")
    mbp = (sum(os.path.getsize(p) for p in genomes + [rep])) / 1e6
    log(f"C. sub_sampler -f ({len(genomes)} genomes + repeat record, "
        f"~{mbp:.0f} MB of FASTA): {t_fof:.1f} s incl. compile; "
        f"reads (-a 2): {t_reads:.1f} s [{card}]")
    log(f"  walker fallback walks: {len(walks)}")
    check(len(walks) >= 1, "the repeat-rich record took no walker "
          "fallback")
    outs = []
    for p, fut in zip(genomes + [rep, reads], oracle_futs):
        out = "c_" + os.path.basename(p).split(".")[0] + ".gz"
        check(gunzip(out) == fut.get(timeout=1800),
              f"sketch of {os.path.basename(p)} differs from the oracle")
        outs.append(out)
    log(f"  {len(outs)} sketches byte-equal to the oracle")

    with open("sk.txt", "w") as f:
        f.write("\n".join(outs) + "\n")
    with open("q.txt", "w") as f:
        f.write("\n".join(outs[:2]) + "\n")
    with open("bank.txt", "w") as f:
        f.write("\n".join(outs[2:]) + "\n")
    t0 = time.perf_counter()
    quiet(cli_cmp.main, ["-f", "sk.txt", "-o", "avsa"])
    t_avsa = time.perf_counter() - t0
    quiet(cli_cmp.main, ["-q", "q.txt", "-f", "bank.txt", "-o", "qry"])
    ref = TpuComparator(engine="numpy")
    ref.files_names = list(outs)
    ref.compare_sketches(len(outs))
    qref = TpuComparator(engine="numpy")
    qref.files_names = list(outs)
    qref.compare_sketches(2)
    for kind in ("containment", "jaccard"):
        check(gunzip(f"avsa_{kind}.csv.gz").decode()
              == getattr(ref, f"{kind}_csv")(), f"all-vs-all {kind}")
        check(gunzip(f"qry_{kind}.csv.gz").decode()
              == getattr(qref, f"{kind}_csv")(), f"query {kind}")
    log(f"  comparator all-vs-all ({len(outs)} sketches) {t_avsa:.2f} s "
        f"and -q (2 queries): CSVs equal the numpy engine's [{card}]")


def phase_d(card, sz):
    import jax
    import jax.numpy as jnp

    from supersampler_tpu.cli import sub_sampler as cli_sub
    from supersampler_tpu.compare.merge import TpuComparator
    from supersampler_tpu.core.scalar import compute_threshold
    from supersampler_tpu.ops import field as F
    from supersampler_tpu.ops.minimizer import pack_2bit_np
    from supersampler_tpu.parallel.mesh import (make_mesh,
                                                sharded_field_resolve_fn)

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found "
          f"{len(devs)}")
    mesh = make_mesh(devs)
    rng = np.random.default_rng(44)
    B_n, P_rec = 4 * sz["d_batch"], 16384
    lens = rng.integers(1000, 16_001, B_n).astype(np.int32)
    lens = np.minimum(lens, P_rec - 256)
    codes = rng.integers(0, 4, (B_n, P_rec), dtype=np.uint8)
    codes[np.arange(P_rec)[None, :] >= lens[:, None]] = 0
    packed = np.stack([pack_2bit_np(r) for r in codes])
    thr = compute_threshold(K, M, 50.0)
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)
    per = B_n // 4
    cap = 1 << 20
    one = []
    for i in range(4):
        arr = F.scan_resolve_batch(
            jax.device_put(packed[i * per : (i + 1) * per], devs[0]), K, M,
            P_rec, cap, jax.device_put(lens[i * per : (i + 1) * per],
                                       devs[0]), thi, tlo)
        one.append(np.asarray(arr))
    check(all(int(a[0]) == 0 and int(a[1]) <= cap for a in one),
          "one-card batches resolved within capacity")
    fn = sharded_field_resolve_fn(mesh, K, M, P_rec, cap)
    t0 = time.perf_counter()
    mesh_arr = np.asarray(fn(packed, lens, thi, tlo))
    t_mesh = time.perf_counter() - t0
    check(mesh_arr.shape[0] == 4 and all(
        np.array_equal(mesh_arr[i], one[i]) for i in range(4)),
        "mesh field engine != one card")
    log(f"D. sharded field engine, 4 x {per} records of 1-16 kb: each "
        f"card's fetch array equals one card's ({t_mesh:.1f} s first "
        f"call incl. compile) [{card}]")

    d = os.path.join(WORK, "d")
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    paths = []
    for fam in range(sz["d_genomes"] // 10 or 1):
        base = rng.integers(0, 4, sz["d_genome"], dtype=np.uint8)
        for i in range(min(10, sz["d_genomes"])):
            p = f"dg{fam}_{i}.fa"
            write_fasta(p, [(p, mutate(base, 0.002 * (i + 1), rng))])
            paths.append(p)
    with open("fof.txt", "w") as f:
        f.write("\n".join(paths) + "\n")
    rc, _ = quiet(cli_sub.main, ["-f", "fof.txt", "-s", "50", "-p", "d_"])
    check(rc == 0, "sketching the comparator corpus")
    sk = ["d_" + p.split(".")[0] + ".gz" for p in paths]
    dev = TpuComparator(engine="device", mesh=mesh)
    dev.files_names = list(sk)
    t0 = time.perf_counter()
    dev.compare_sketches(len(sk))
    t_cmp = time.perf_counter() - t0
    ref = TpuComparator(engine="numpy")
    ref.files_names = list(sk)
    ref.compare_sketches(len(sk))
    check(dev.containment_csv() == ref.containment_csv()
          and dev.jaccard_csv() == ref.jaccard_csv(),
          "mesh comparator CSVs != numpy engine")
    log(f"D. mesh comparator over {len(sk)} sketches: CSVs equal the "
        f"numpy engine's ({t_cmp:.1f} s incl. compile) [{card}]")
    return len(devs)


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase D (the four-card mesh paths)")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="tiny sizes on the CPU; never prints a result")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "supersampler_tpu")):
        log("chip_smoke.py must run from a checkout of the repository")
        return 2
    rehearse = args.rehearse_cpu
    sz = TINY if rehearse else FULL
    cards = card_lines()
    if cards is None and not rehearse:
        log("no NVIDIA GPU: nvidia-smi found no card")
        return 2
    card = cards[0] if cards else "cpu rehearsal"
    for ln in cards or []:
        log(f"card: {ln}")
    sys.path.insert(0, REPO)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    cwd = os.getcwd()
    pool = None
    try:
        if not args.four_cards:
            corpus = make_corpus(os.path.join(WORK, "c"), sz)
            genomes, rep, reads = corpus
            jobs = [(p, 1) for p in genomes + [rep]] + [(reads, 2)]
            ctx = multiprocessing.get_context("spawn")
            pool = ctx.Pool(min(len(jobs), max(1, (os.cpu_count() or 2)
                                               - 2)),
                            initializer=_cpu_worker)
            futs = [pool.apply_async(oracle_sketch, j) for j in jobs]
            if not rehearse:
                run_gpu_tests()

        import jax

        from supersampler_tpu import enable_compilation_cache
        from supersampler_tpu.native import NativeFinisher

        enable_compilation_cache()
        dev0 = jax.devices()[0]
        if dev0.platform != "gpu" and not rehearse:
            log(f"JAX found no GPU (platform {dev0.platform})")
            return 2
        log(f"jax {jax.__version__}: {len(jax.devices())} x "
            f"{dev0.device_kind} ({dev0.platform})")
        check(NativeFinisher.available(), "the native finisher did not "
              "load")
        if args.four_cards:
            count = phase_d(card, sz)
        else:
            phase_a(card)
            phase_b(card, sz, interpret=rehearse)
            phase_c(card, corpus, futs)
            count = len(jax.devices())
        stats = dev0.memory_stats() or {}
        log(f"peak device memory: "
            f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB "
            f"[{card}]")
    except Failed as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        os.chdir(cwd)
        if pool is not None:
            pool.terminate()
            pool.join()
    for ln in cards or []:
        log(f"card: {ln}")
    if rehearse:
        log("rehearsal passed (cpu); no result line")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": count}}), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
