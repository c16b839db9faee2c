"""Benchmark: sketch-construction + comparison throughput on the device.

Prints ONE JSON line:
  {"metric": "sketch_throughput", "value": <Mbases/s>, "unit":
   "Mbases/s", "device": {...}, "detail": {...}}

Sketching rates (median over TRIALS, with spread = (max-min)/median so
run-to-run noise is visible in the record):

  * field_kernel: DATA-RESIDENT rate of the fused scan+resolve program
    — packed inputs pre-staged on the device, timed by the difference
    between a 2N-record and an N-record queue drain (cancels the
    constant dispatch + final-fetch latency);
  * walker_kernel: the same protocol for the successor-table + chain
    walk engine (the exact fallback);
  * device_path: N records' H2D + scan + resolve + compact enqueued
    back-to-back, wall-clocked to the final record's fetch;
  * end_to_end: TpuSubsampler.sketch_file wall time including FASTA
    parsing, transfers, host assembly and serialization — the
    headline value;
  * reads / fof / cold_fof: 10k x 1 kb reads, the same 8 records as 8
    files through one shared pipeline, and that fof in a fresh process
    (run before this process opens the device: one process per card).

Also reported: all-vs-all comparison wall time through the device
(presence-matmul) engine over the corpus's sketches, and a
virtual-8-device CPU mesh overhead probe for the sharded comparator
(t8/t1 on CPU devices: sharding overhead, not multi-card scaling).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K, M, S = 31, 11, 1000.0
PAD = 1 << 22          # 4 Mbp tiles
NREC = 8
TRIALS = 5


def _stats(ts):
    med = statistics.median(ts)
    return med, {"median_s": round(med, 4), "min_s": round(min(ts), 4),
                 "max_s": round(max(ts), 4), "trials": len(ts),
                 "spread": round((max(ts) - min(ts)) / med, 3)}


def _cold_fof(fof_path):
    """The fof corpus in a fresh process (bench_cold_fof.py), run while
    this process has not opened the device yet."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "bench_cold_fof.py"),
         fof_path, str(K), str(M), str(S)],
        capture_output=True, text=True, timeout=900, cwd=here)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError("bench_cold_fof.py failed: "
                           + out.stderr[-2000:])
    cold = json.loads(out.stdout.strip().splitlines()[-1])
    cold["note"] = ("fresh process: cold_total_s includes compilation "
                    "or compile-cache loading; warm_repeat_s is the "
                    "same corpus again in that process")
    return cold


def main():
    rng = np.random.default_rng(1312)
    glen = PAD - 512
    nuc = np.frombuffer(b"ACGT", np.uint8)

    # shared synthetic inputs
    record_codes = [rng.integers(0, 4, size=glen, dtype=np.uint8)
                    for _ in range(NREC)]
    tmpdir = tempfile.mkdtemp(prefix="spsp_bench_")
    fof_files = []
    for i, codes in enumerate(record_codes):
        p = os.path.join(tmpdir, f"fof{i}.fa")
        with open(p, "w") as f:
            f.write(f">f{i}\n{nuc[codes].tobytes().decode()}\n")
        fof_files.append(p)
    fof_path = os.path.join(tmpdir, "fof.txt")
    with open(fof_path, "w") as f:
        f.write("\n".join(fof_files) + "\n")
    cold_fof = _cold_fof(fof_path)

    import jax
    import jax.numpy as jnp

    from supersampler_tpu import enable_compilation_cache
    enable_compilation_cache()

    from supersampler_tpu.core.scalar import compute_threshold
    from supersampler_tpu.ops import u64 as U
    from supersampler_tpu.ops.minimizer import (pack_2bit_np,
                                                scan_tables_2d_packed)
    from supersampler_tpu.ops.walker import DeviceChain
    from supersampler_tpu.sketch.pipeline import TpuSubsampler

    thr = compute_threshold(K, M, S)
    thrv = U.U64(jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF))
    scan = jax.jit(scan_tables_2d_packed, static_argnums=(1, 2, 3))
    packed_in = []
    for codes in record_codes:
        c = np.zeros(PAD, np.uint8)
        c[:glen] = codes
        packed_in.append(pack_2bit_np(c))

    # --- kernel: data-resident difference timing -----------------------
    # (a) the sync-field engine (the product default, ops/field.py),
    # via the fused scan+entry+resolve program the pipeline dispatches.
    # The device pool holds 2*NREC DISTINCT buffers so the long drain
    # (2*NREC) never re-runs a (program, buffer) pair.
    from supersampler_tpu.ops.field import scan_resolve_single

    kern_codes = record_codes + [
        rng.integers(0, 4, size=glen, dtype=np.uint8)
        for _ in range(NREC)]
    ext_in = []
    for codes in kern_codes:
        c = np.zeros(128 + PAD + 512, np.uint8)
        c[128 : 128 + glen] = codes
        ext_in.append(pack_2bit_np(c))
    P_T = PAD + 512
    ext_dev = [jax.device_put(p) for p in ext_in]
    packed_dev = [jax.device_put(p) for p in packed_in]
    for codes in kern_codes[NREC:]:
        c = np.zeros(PAD, np.uint8)
        c[:glen] = codes
        packed_dev.append(jax.device_put(pack_2bit_np(c)))
    # force the H2D transfers to complete before timing anything
    for p in ext_dev + packed_dev:
        np.asarray(jnp.sum(p.astype(jnp.uint32)))
    thi, tlo = jnp.uint32(thr >> 32), jnp.uint32(thr & 0xFFFFFFFF)

    def drain_field(n):
        t0 = time.perf_counter()
        arr = None
        for i in range(n):
            arr = scan_resolve_single(ext_dev[i % len(ext_dev)], K, M,
                                      P_T, 4096, jnp.int32(glen), thi,
                                      tlo)
        jax.device_get(arr)     # drains the in-order device queue
        return time.perf_counter() - t0

    def check_field_arr():
        # an overflow/failure would silently time truncated work and
        # corrupt the ledger: verify once outside the timed region
        a = jax.device_get(scan_resolve_single(
            ext_dev[0], K, M, P_T, 4096, jnp.int32(glen), thi, tlo))
        assert int(a[0]) == 0 and int(a[1]) <= 4096, (
            "field resolve invalid on bench input", int(a[0]), int(a[1]))

    drain_field(2)              # compile + warm
    check_field_arr()
    tf_s, f_short = _stats([drain_field(NREC) for _ in range(TRIALS)])
    tf_l, f_long = _stats([drain_field(2 * NREC) for _ in range(TRIALS)])
    field_dt = max(tf_l - tf_s, 1e-9)
    field_mbps = NREC * glen / 1e6 / field_dt

    # (b) the successor-table + chain-walk engine (the exact
    # fallback; the sync-field engine above is the product default)
    def drain(n):
        t0 = time.perf_counter()
        dc = None
        for i in range(n):
            t = scan(packed_dev[i % len(packed_dev)], K, M, PAD,
                     jnp.int32(glen), thrv)
            dc = DeviceChain(t)
        dc.compact()            # drains the in-order device queue
        return time.perf_counter() - t0

    drain(2)                    # compile + warm
    t_short, short_st = _stats([drain(NREC) for _ in range(TRIALS)])
    t_long, long_st = _stats([drain(2 * NREC) for _ in range(TRIALS)])
    kernel_dt = max(t_long - t_short, 1e-9)
    kernel_mbps = NREC * glen / 1e6 / kernel_dt

    # --- device path (H2D inside the loop, the fused field program,
    # one final fetch) --------------------------------------------------
    def device_path_once():
        t0 = time.perf_counter()
        arr = None
        for p in ext_in:
            arr = scan_resolve_single(jax.device_put(p), K, M, P_T,
                                      4096, jnp.int32(glen), thi, tlo)
        jax.device_get(arr)
        return time.perf_counter() - t0

    dp_med, dp_st = _stats([device_path_once() for _ in range(TRIALS)])
    device_mbps = NREC * glen / 1e6 / dp_med

    # --- end to end: full public pipeline over one FASTA ---------------
    fa_path = os.path.join(tmpdir, "bench.fa")
    with open(fa_path, "w") as f:
        for i, codes in enumerate(record_codes):
            f.write(f">r{i}\n")
            f.write(nuc[codes].tobytes().decode())
            f.write("\n")
    try:
        TpuSubsampler(k=K, m=M, s=S).sketch_file(fa_path)   # warm
        e2e_ts = []
        for _ in range(TRIALS):
            ss = TpuSubsampler(k=K, m=M, s=S)
            t0 = time.perf_counter()
            ss.sketch_file(fa_path)
            e2e_ts.append(time.perf_counter() - t0)
        e2e_med, e2e_st = _stats(e2e_ts)
        e2e_mbps = NREC * glen / 1e6 / e2e_med

        # --- reads corpus: 10k x 1 kb records through the batched
        # short-record engine (one fused dispatch + one fetch per
        # record batch) ------------------------------------------------
        n_reads, read_len = 10000, 1000
        reads_fa = os.path.join(tmpdir, "reads.fa")
        rcodes = rng.integers(0, 4, size=(n_reads, read_len),
                              dtype=np.uint8)
        with open(reads_fa, "w") as f:
            for i in range(n_reads):
                f.write(f">q{i}\n")
                f.write(nuc[rcodes[i]].tobytes().decode())
                f.write("\n")
        reads_mb = n_reads * read_len / 1e6
        TpuSubsampler(k=K, m=M, s=S).sketch_file(reads_fa)   # warm
        r_ts = []
        for _ in range(TRIALS):
            ss = TpuSubsampler(k=K, m=M, s=S)
            t0 = time.perf_counter()
            ss.sketch_file(reads_fa)
            r_ts.append(time.perf_counter() - t0)
        reads_med, reads_st = _stats(r_ts)
        reads_mbps = reads_mb / reads_med

        # --- fof mode: the same 8 records as 8 files through ONE
        # shared pipeline (sketch_fof), warm; the cold run in a fresh
        # process ran before this process opened the device ----------
        from supersampler_tpu.sketch.pipeline import sketch_fof

        def fof_once():
            items = [(TpuSubsampler(k=K, m=M, s=S), p)
                     for p in fof_files]
            t0 = time.perf_counter()
            sketch_fof(items)
            return time.perf_counter() - t0

        fof_once()          # warm
        fof_med, fof_st = _stats([fof_once() for _ in range(TRIALS)])
        fof_mbps = NREC * glen / 1e6 / fof_med

        # --- all-vs-all comparison over the corpus's sketches ----------
        from supersampler_tpu.compare.merge import TpuComparator
        from supersampler_tpu.sketch import subsample_file

        cwd = os.getcwd()
        os.chdir(tmpdir)
        try:
            sketches = []
            for i, codes in enumerate(record_codes):
                p = os.path.join(tmpdir, f"rec{i}.fa")
                with open(p, "w") as f:
                    f.write(f">rec{i}\n{nuc[codes].tobytes().decode()}\n")
                ss = TpuSubsampler(k=K, m=M, s=S)
                sketches.append(subsample_file(ss, p, "bench_"))

            def compare_once():
                comp = TpuComparator(engine="device")
                comp.files_names = list(sketches)
                t0 = time.perf_counter()
                comp.compare_sketches(len(sketches))
                comp.containment_csv()
                comp.jaccard_csv()
                return time.perf_counter() - t0

            compare_once()      # warm
            cmp_med, cmp_st = _stats([compare_once() for _ in range(3)])
            n_pairs = NREC * (NREC - 1) // 2
        finally:
            os.chdir(cwd)
    finally:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)

    # --- virtual 8-device mesh overhead probe (CPU subprocess) ---------
    mesh_probe = None
    try:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")
        out = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "bench_mesh_probe.py")],
            capture_output=True, text=True, timeout=600, env=env)
        if out.returncode == 0 and out.stdout.strip():
            mesh_probe = json.loads(out.stdout.strip().splitlines()[-1])
    except Exception:
        mesh_probe = None

    dev = jax.devices()[0]
    result = {
        "metric": "sketch_throughput",
        "value": round(e2e_mbps, 1),
        "unit": "Mbases/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "detail": {
            "end_to_end_mbases_s": round(e2e_mbps, 1),
            "end_to_end": e2e_st,
            "reads_e2e_mbases_s": round(reads_mbps, 1),
            "reads_e2e": dict(reads_st, records=n_reads,
                              read_len=read_len),
            "fof_e2e_mbases_s": round(fof_mbps, 1),
            "fof_e2e": dict(fof_st, files=NREC),
            "cold_fof": cold_fof,
            "field_kernel_mbases_s": round(field_mbps, 1),
            "field_kernel": {"short": f_short, "long": f_long,
                             "diff_s": round(field_dt, 4),
                             "engine": "sync-field fused (default)"},
            "walker_kernel_mbases_s": round(kernel_mbps, 1),
            "walker_kernel": {"short": short_st, "long": long_st,
                              "diff_s": round(kernel_dt, 4),
                              "engine": "succ-tables+walker (fallback)"},
            "device_path_mbases_s": round(device_mbps, 1),
            "device_path": dp_st,
            "compare_allvsall": dict(cmp_st, files=NREC, pairs=n_pairs),
            "mesh8_probe": mesh_probe,
            "config": {"k": K, "m": M, "s": S, "tile": PAD,
                       "records": NREC},
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
