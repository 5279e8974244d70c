"""k=12 precalc table at reference scale: byte-parity + timing.

Builds a small IUPAC-bearing world, has the compiled reference aligner
lazily build its 4^12-entry `.pre` (precalc_sa_intervals, align.c:200-224)
during a `-P` align, then builds the same table with the level-wise device
builder and byte-compares both the `.pre` file and the `-P` `.aln` output.

Usage:
  python scripts/precalc_k12_parity.py [--world DIR] [--keep]

With --world pointing at a directory that already holds w.fa / oracle
artifacts (from a previous run), the expensive oracle step is skipped.
Runs on the CPU backend (JAX_PLATFORMS=cpu upstream of the jax import).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

# force the CPU backend the same way tests/conftest.py does
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def ensure_world(d: str) -> None:
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.index import FMIndex
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq

    fa = os.path.join(d, "w.fa")
    if not os.path.exists(fa):
        random_genome_fasta(fa, {"chr1": 100_000}, seed=11, iupac_frac=0.002)
        simulate_reads_fastq(fa, os.path.join(d, "w.fq"), 40, read_len=100,
                             num_mm=2, seed=13)
    if not os.path.exists(fa + ".bwt"):
        codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
        FMIndex.build(codes).store(fa + ".bwt")


def ensure_oracle_artifacts(d: str, oracle: str) -> None:
    """Reference `-n 2 -P` align: lazily builds + stores oracle/w.fa.pre.

    The `.aln` is ALWAYS regenerated (it is cheap once the `.pre` exists)
    so a stale file from a manual run with different flags can never
    poison the comparison; `-n 2` so the parity check covers real
    alignments, not 40 empty records."""
    od = os.path.join(d, "oracle")
    os.makedirs(od, exist_ok=True)
    for ext in ("", ".ref", ".ann", ".bwt"):
        src = os.path.join(d, "w.fa" + ext)
        dst = os.path.join(od, "w.fa" + ext)
        if not os.path.exists(dst):
            import shutil
            shutil.copy(src, dst)
    t0 = time.time()
    subprocess.run(
        [oracle, "align", "-n", "2", "-P", os.path.join(od, "w.fa"),
         os.path.join(d, "w.fq"), os.path.join(od, "w.aln")],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"oracle -n2 -P align (incl. lazy .pre build): "
          f"{time.time()-t0:.1f}s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--skip-build", action="store_true",
                    help="reuse an existing byte-verified w.fa.pre in the "
                         "world dir instead of rebuilding (25 min on CPU)")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    oracle = os.path.join(repo, ".oracle", "bwbble")
    if not os.path.exists(oracle):
        sys.path.insert(0, os.path.join(repo, "tests"))
        from conftest import _ensure_oracle
        if _ensure_oracle() is None:
            print("no oracle binary; aborting", file=sys.stderr)
            return 2

    d = args.world or tempfile.mkdtemp(prefix="k12_")
    os.makedirs(d, exist_ok=True)
    print(f"world: {d}", flush=True)
    ensure_world(d)
    ensure_oracle_artifacts(d, oracle)

    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.align.precalc import (
        PRECALC_LEN, build_precalc_device, load_pre, store_pre)
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.index import FMIndex

    fa = os.path.join(d, "w.fa")
    idx = FMIndex.load(fa + ".bwt")
    params = AlnParams()

    mine = fa + ".pre"
    if args.skip_build and os.path.exists(mine):
        print(f"--skip-build: reusing {mine}", flush=True)
    else:
        t0 = time.time()
        table = build_precalc_device(idx, from_fmindex(idx), params,
                                     k=PRECALC_LEN)
        t_build = time.time() - t0
        print(f"device k=12 build: {t_build:.1f}s "
              f"({len(table)} entries, {table.L.shape[0]} intervals)",
              flush=True)

        t0 = time.time()
        store_pre(mine, table)
        print(f"store_pre: {time.time()-t0:.1f}s", flush=True)

    ref_pre = os.path.join(d, "oracle", "w.fa.pre")
    a = open(mine, "rb").read()
    b = open(ref_pre, "rb").read()
    if a != b:
        print(f"MISMATCH: .pre differs (mine {len(a)} B, oracle {len(b)} B)")
        return 1
    print(f".pre byte-parity OK ({len(a)} bytes)", flush=True)

    t0 = time.time()
    back = load_pre(mine)
    print(f"load_pre: {time.time()-t0:.1f}s", flush=True)
    if not args.skip_build:
        assert np.array_equal(back.cnt, table.cnt)

    # -P align through our CLI vs the oracle's .aln
    from bwbble_tpu.cli import main as cli_main
    my_aln = os.path.join(d, "mine.aln")
    rc = cli_main(["align", "-n", "2", "-P", fa, os.path.join(d, "w.fq"),
                   my_aln])
    if rc not in (0, None):
        print(f"align CLI failed rc={rc}")
        return 1
    ra = open(my_aln, "rb").read()
    rb = open(os.path.join(d, "oracle", "w.aln"), "rb").read()
    if ra != rb:
        print(f"MISMATCH: -P .aln differs (mine {len(ra)} B, oracle {len(rb)} B)")
        return 1
    print("-P .aln byte-parity OK", flush=True)
    print("k12-parity: ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
