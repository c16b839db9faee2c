"""Worker process for the real 2-process distributed comparator test
(spawned by tests/test_dist.py). Runs compare_all_vs_all_distributed
under an actual jax.distributed runtime on CPU; process 0 writes the
CSVs for the parent to diff against the single-host engine."""

import os
import sys


def main():
    port, pid, nproc, fof, outdir = sys.argv[1:6]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=int(nproc), process_id=int(pid))
    from supersampler_tpu.parallel.dist import (
        compare_all_vs_all_distributed)

    files = [ln.strip() for ln in open(fof) if len(ln.strip()) > 2]
    comp = compare_all_vs_all_distributed(files)
    if jax.process_index() == 0:
        with open(os.path.join(outdir, "containment.csv"), "w") as f:
            f.write(comp.containment_csv())
        with open(os.path.join(outdir, "jaccard.csv"), "w") as f:
            f.write(comp.jaccard_csv())
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
