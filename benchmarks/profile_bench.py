"""Phase-level timing of the headline bench workload.

Splits align_reads_device time into: difficulty scoring, calc_d, the
inexact_search launch, path walks, and host collection; reports the
engine's iteration/pop counters so per-iteration cost is measurable.

Run: python benchmarks/profile_bench.py [--queued]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench as benchmod
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.inexact import EngineConfig, inexact_search
    from bwbble_tpu.engine.pipeline import (align_reads_device, calc_d_all,
                                            _run_batch)

    idx, reads = benchmod.build_world()
    didx = from_fmindex(idx)
    B = 8192
    params = AlnParams(max_diff=4, batch_size=B)
    cfg = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)

    # ---- full pipeline timing (warm + timed), mirrors bench.py
    align_reads_device(idx, didx, reads, params, cfg, d_cap=16, window=3)
    stats: dict = {}
    t0 = time.time()
    align_reads_device(idx, didx, reads, params, cfg, d_cap=16,
                       stats=stats, window=3)
    t_total = time.time() - t0
    print(f"total align_reads_device: {t_total:.3f}s "
          f"({reads.count / t_total:.0f} reads/s) stats={stats}")

    # ---- phase 1: shared D pass
    t0 = time.time()
    D_all, Ds_all, dov = calc_d_all(didx, reads, params, batch=B, d_cap=16)
    jax.block_until_ready((D_all, Ds_all))
    t_diff = time.time() - t0
    print(f"calc_d_all (K=2 + retries, all reads): {t_diff:.3f}s  "
          f"dov={int(dov.sum())}")

    # ---- per-batch phases on the first B reads
    seq = jnp.asarray(reads.seq[:B].astype(np.int8))
    rc = jnp.asarray(reads.rc[:B].astype(np.int8))
    lengths_np = reads.lengths[:B].astype(np.int32)
    lengths = jnp.asarray(lengths_np)

    from bwbble_tpu.engine.dbound import calc_d
    for K in (2, 4, 16):
        f = jax.jit(lambda s, l: calc_d(didx, s, l, K=K))
        jax.block_until_ready(f(seq, lengths))
        t0 = time.time()
        out = f(seq, lengths)
        jax.block_until_ready(out)
        print(f"calc_d K={K} [B={B}]: {time.time() - t0:.3f}s  "
              f"overflow={int(np.asarray(out[1]).sum())}")

    # search alone (D precomputed)
    D, _ = calc_d(didx, seq, lengths, K=16)
    sl = jnp.asarray(np.where(lengths_np > 32, 32, 0).astype(np.int32))
    Ds, _ = calc_d(didx, seq, sl, K=16, max_len=32)
    jax.block_until_ready((D, Ds))
    t0 = time.time()
    res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
    jax.block_until_ready(res)
    t_search = time.time() - t0
    iters = int(np.asarray(res["iters"]))
    print(f"inexact_search alone: {t_search:.3f}s  iters={iters}  "
          f"-> {t_search / max(iters, 1) * 1e3:.3f} ms/iter")

    # how many lanes are in each mode over time is not visible; report
    # distribution of per-read n_alns and overflow instead
    print(f"n_alns mean={float(np.asarray(res['n_alns']).mean()):.2f} "
          f"overflow={int(np.asarray(res['overflow']).sum())}")


if __name__ == "__main__":
    main()
