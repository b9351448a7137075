"""Which single-device direct path is fastest, end to end, on the GPU.

Runs ``run_simulation(architecture='gpu', method='direct')`` on a
Plummer sphere (h = 0.05, spline, float32_kahan) once per backend and
reports the steady-state step time: the run is split into two equal
chunks and the second chunk's rate is taken (the first includes
compilation).  Also times one force evaluation of each backend.  Prints
one JSON line per (N, impl) and the card's name and power limit first.

Usage:  python benchmarks/direct_paths.py [N ...] [--steps K]
        (default N = 65536 1048576; K steps per chunk, default 100 at
        N <= 262144 and 3 above)
"""
import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

IMPLS = ("pallas", "xla", "jnp")
DT = 2e-5


def chunk_ms(log: str) -> float:
    """The last ``chunk X ms/step`` figure run_nbody printed."""
    return float(re.findall(r"chunk ([0-9.]+) ms/step", log)[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="*", default=[65536, 1048576])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--impls", default=",".join(IMPLS))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from nbody_streams_tpu import Species, make_plummer_sphere, run_simulation
    from nbody_streams_tpu.ops.dispatch import DirectGravity

    if jax.devices()[0].platform != "gpu":
        sys.exit("direct_paths.py measures the GPU; JAX finds none")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for n in args.n:
        k = args.steps or (100 if n <= 262144 else 3)
        xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=2)
        sp = [Species.dark(N=n, mass=float(m[0]), softening=0.05)]
        for impl in args.impls.split(","):
            solver = DirectGravity(m, np.full(n, 0.05), impl=impl)
            pos = jnp.asarray(xv[:, :3], jnp.float32)
            f = jax.jit(solver.accel)
            jax.block_until_ready(f(pos))
            t0 = time.perf_counter()
            jax.block_until_ready(f(pos))
            eval_s = time.perf_counter() - t0
            buf = io.StringIO()
            with tempfile.TemporaryDirectory() as out, \
                    contextlib.redirect_stdout(buf):
                run_simulation(xv, sp, 0.0, 2 * k * DT, DT,
                               architecture="gpu", method="direct",
                               impl=impl, output_dir=out,
                               save_snapshots=False, restart_interval=k,
                               verbose=True)
            ms = chunk_ms(buf.getvalue())
            print(json.dumps({
                "n": n, "impl": impl, "step_ms": ms,
                "step_gint_s": round(n * n / ms / 1e6, 1),
                "eval_ms": round(eval_s * 1e3, 3),
                "eval_gint_s": round(n * n / eval_s / 1e9, 1),
                "steps_per_chunk": k}), flush=True)


if __name__ == "__main__":
    main()
