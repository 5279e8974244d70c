"""Per-op profile of one inexact_search launch on the chr21 world at a
given lane count (default B=1024): where a wave of the XLA body spends its
time.

Run: python benchmarks/profile_iter.py [B] [cap] [outdir]
Prints iteration count, wall time, per-iteration cost, and the top device
ops from a jax-profiler trace of the launch.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    cap = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    outdir = sys.argv[3] if len(sys.argv) > 3 else "/tmp/jaxtrace_iter"

    import bench as benchmod
    from benchmarks.trace_search import summarize
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.inexact import EngineConfig, inexact_search
    from bwbble_tpu.engine.pipeline import calc_d_all

    idx, reads, _d = benchmod.build_world()
    didx = from_fmindex(idx)
    params = AlnParams(max_diff=4, batch_size=B)
    cfg = EngineConfig(cap=cap, acap=24, kx=4, max_iters=100_000)

    rc = jnp.asarray(reads.rc[:B].astype(np.int8))
    lengths = jnp.asarray(reads.lengths[:B].astype(np.int32))
    from bwbble_tpu.formats.fastq import Reads
    sub = Reads(names=reads.names[:B], seq=reads.seq[:B], rc=reads.rc[:B],
                qual=reads.qual[:B], lengths=reads.lengths[:B])
    D, Ds, _ov = calc_d_all(didx, sub, params, batch=B, d_cap=64,
                            host_idx=idx)

    res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
    jax.block_until_ready(res["n_alns"])
    it0 = int(np.asarray(res["iters"]))

    t0 = time.time()
    res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
    jax.block_until_ready(res["n_alns"])
    dt = time.time() - t0
    iters = int(np.asarray(res["iters"]))
    print(f"B={B} cap={cap} iters={iters} (warm {it0}) wall={dt:.3f}s "
          f"-> {dt / max(iters, 1) * 1e6:.1f} us/iter, "
          f"{dt / max(iters, 1) / B * 1e9:.1f} ns/lane-iter")

    with jax.profiler.trace(outdir):
        res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
        jax.block_until_ready(res["n_alns"])
    summarize(outdir, top=50)
    print(f"iters={int(np.asarray(res['iters']))}")


if __name__ == "__main__":
    main()
