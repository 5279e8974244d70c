"""Mesh-scaling check for the sharded alignment step.

On real hardware this measures dp-scaling efficiency (the BASELINE.md north
star: >=80% from 1 chip to N); in this environment it runs on the virtual
CPU mesh, so it validates the sharding program (compiles, executes,
produces alignments at every mesh shape) and reports relative wall times,
which are NOT representative of cards joined by NVLink.

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/scaling.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    # pin the CPU mesh backend when asked for it
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.inexact import EngineConfig
    from bwbble_tpu.parallel import make_mesh, sharded_align_step
    import __graft_entry__ as ge

    ndev = len(jax.devices())
    didx, seq, rc, lengths = ge._tiny_world(genome_bp=60_000, num_reads=64,
                                            read_len=64, seed=5)
    params = AlnParams(max_diff=2)
    cfg = EngineConfig(cap=8192, acap=8, kx=4, max_iters=20_000)

    base = None
    for dp in (1, 2, 4, 8):
        if dp > ndev:
            break
        tp = 2 if ndev >= 2 * dp else 1
        mesh = make_mesh(dp, tp)
        out = sharded_align_step(mesh, didx, seq, rc, lengths, params, cfg,
                                 d_cap=8)
        jax.block_until_ready(out)          # compile + first run
        t0 = time.time()
        out = sharded_align_step(mesh, didx, seq, rc, lengths, params, cfg,
                                 d_cap=8)
        jax.block_until_ready(out)
        dt = time.time() - t0
        n = int(np.asarray(out["n_alns"]).sum())
        base = base or dt
        print(f"dp={dp} tp={tp}: {dt * 1e3:8.1f} ms  alns={n}  "
              f"speedup={base / dt:.2f}x")


if __name__ == "__main__":
    main()
