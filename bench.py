"""Headline benchmark: chr21-scale multi-genome inexact alignment (reads/s).

The honest workload — everything the aligner exists for:
- 46.7 Mbp chr21-like reference with diverged-repeat structure (30% of
  500 bp blocks are mutated copies of earlier blocks);
- a synthetic 1000G-style VCF at 1 SNP / 100 bp and 1 indel / 1000 bp,
  folded in by the native mg-ref tools (data_prep + comb -w 124): SNPs
  become IUPAC codes, indels become appended bubble sequences — the same
  pipeline as the reference's mg-ref/sample_usage.sh;
- 16,384 x 100 bp reads of mixed difficulty: Poisson(1.2) mismatches
  (capped at 4) and a 1-3 bp indel on 12% of reads, both strands;
- alignment with -n 4 (gaps enabled via default -o 1 -e 6).

Self-verifying: the baseline is MEASURED IN-BAND —
this script compiles the reference aligner (gcc -O3, one core), runs
`bwbble align -n 4` once on the exact same reads, and caches the result
in .bench/<world>/baseline*.json; there are no hardcoded baseline
constants.  The oracle's `.aln` output is kept and the device run's
`.aln` is byte-compared against it — the JSON line carries
`parity: true/false` alongside the throughput ratio.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "parity"}.
"""

from __future__ import annotations

import filecmp
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

GENOME_BP = 46_700_000
EASY_BP = 5_000_000
NUM_READS = 16_384      # reads in the cached worlds
CHR21_BENCH_READS = 8_192   # aligned by the chr21 bench run (rate metric)
READ_LEN = 100

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench")


def _mgref_binary():
    exe = os.path.join(ROOT, "native", "build", "mgref")
    if not os.path.exists(exe):
        subprocess.run([sys.executable, "-m", "bwbble_tpu.build_native"],
                       check=True, cwd=ROOT)
    return exe


def oracle_binary() -> str:
    """The compiled reference aligner (same build as tests/conftest.py)."""
    exe = os.path.join(ROOT, ".oracle", "bwbble")
    if not os.path.exists(exe):
        os.makedirs(os.path.dirname(exe), exist_ok=True)
        srcs = glob.glob("/root/reference/mg-aligner/*.c")
        subprocess.run(["gcc", "-O3", "-std=gnu99", "-fopenmp", *srcs,
                        "-o", exe, "-lm", "-lz", "-lpthread"], check=True)
    return exe


def subset_fastq(fq: str, n: int) -> str:
    """First n records of fq, cached next to it."""
    sub = os.path.join(os.path.dirname(fq), f"reads_sub{n}.fq")
    if not os.path.exists(sub):
        with open(fq, "rb") as f, open(sub, "wb") as g:
            for _ in range(4 * n):
                g.write(f.readline())
    return sub


def ensure_baseline(world: str, fa: str, fq: str, n_reads: int,
                    tag: str = "",
                    align_args: tuple = ("-n", "4")) -> tuple[float, str]:
    """Measure the reference aligner on (fa, fq) once; cache the result.

    Returns (matching_reads_per_sec, oracle_aln_path).  The rate divides
    by the reference's own per-batch "matching time" printf
    (inexact_match.c:67) — i.e. pure search compute, excluding its index/
    read load phases, which is the STRICTER baseline for us (our measured
    span includes D bounds, transfers and result assembly)."""
    bj = os.path.join(world, f"baseline{tag}.json")
    aln = os.path.join(world, f"oracle{tag}.aln")
    if os.path.exists(bj) and os.path.exists(aln):
        with open(bj) as f:
            d = json.load(f)
        if d.get("num_reads") == n_reads:
            return float(d["reads_per_sec_matching_only"]), aln
    exe = oracle_binary()
    # the oracle writes <fa>.{ref,ann,bwt} next to the fasta; index a copy
    # so our own artifacts aren't clobbered
    ofa = os.path.join(world, "oracle_" + os.path.basename(fa))
    if not os.path.exists(ofa):
        shutil.copy(fa, ofa)
    if not os.path.exists(ofa + ".bwt"):
        t0 = time.time()
        subprocess.run([exe, "index", ofa], check=True,
                       stdout=subprocess.DEVNULL)
        sys.stderr.write(f"[bench] oracle index: {time.time() - t0:.1f}s\n")
    if os.path.exists(aln):
        os.remove(aln)
    t0 = time.time()
    r = subprocess.run([exe, "align", *align_args, ofa, fq, aln],
                       check=True, capture_output=True, text=True)
    dt = time.time() - t0
    # "Processed N reads. Inexact matching time: T sec." — cumulative
    # across batches (inexact_match.c:67), so take the last occurrence
    m = re.findall(r"Inexact matching time: ([0-9.]+) sec", r.stdout)
    t_match = float(m[-1]) if m else dt
    rps_total = n_reads / dt
    rps_match = n_reads / t_match if t_match > 0 else rps_total
    sys.stderr.write(
        f"[bench] oracle align: total {dt:.2f}s ({rps_total:.0f} r/s), "
        f"matching {t_match:.2f}s ({rps_match:.0f} r/s)\n")
    with open(bj, "w") as f:
        json.dump({"reads_per_sec": round(rps_total, 2),
                   "reads_per_sec_matching_only": round(rps_match, 2),
                   "align_wall_s": round(dt, 3),
                   "matching_s": round(t_match, 3),
                   "num_reads": n_reads,
                   "cmd": "bwbble align " + " ".join(align_args)
                          + " (gcc -O3, 1 core, in-band)",
                   "date": time.strftime("%Y-%m-%d %H:%M:%S")}, f, indent=1)
    return rps_match, aln


def write_chr21_inputs(d: str, num_reads: int, hard: bool = False,
                       genome_bp: int = GENOME_BP) -> tuple[str, str]:
    """Write (once, cached in `d`) the chr21-scale multi-genome inputs;
    returns (bubble FASTA, reads FASTQ).

    Default: diverged repeats (15% of blocks are single copies of fresh
    blocks at 5% divergence — near the -n 4 ambiguity boundary).  hard=True
    instead allows copies of copies: preferential-attachment families with
    hundreds of near-identical members (young-Alu-like pathology; both
    aligners slow dramatically and the comparison is reported separately).
    """
    from bwbble_tpu.testutil import (random_genome_with_repeats_fasta,
                                     simulate_reads_fastq, synthetic_vcf)

    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "genome.fa")
    vcf = os.path.join(d, "variants.vcf")
    mg = os.path.join(d, "mg.fa")
    mgb = os.path.join(d, "mg_bubble.fa")
    bdata = os.path.join(d, "bubble.data")
    fq = os.path.join(d, f"reads_{num_reads}.fq")

    if not os.path.exists(fa):
        if hard:
            random_genome_with_repeats_fasta(fa, "21", genome_bp, seed=11,
                                             repeat_frac=0.3, block=500,
                                             mut_rate=0.02, chains=True)
        else:
            random_genome_with_repeats_fasta(fa, "21", genome_bp, seed=11,
                                             repeat_frac=0.15, block=500,
                                             mut_rate=0.05)
    if not os.path.exists(vcf):
        synthetic_vcf(fa, vcf, snp_rate=0.01, indel_rate=0.001, seed=12)
    if not os.path.exists(mgb):
        exe = _mgref_binary()
        os.makedirs(os.path.join(d, "mg-ref-output"), exist_ok=True)
        subprocess.run([exe, "data_prep", "-c", vcf], check=True, cwd=d,
                       stdout=subprocess.DEVNULL)
        subprocess.run([exe, "comb", "-w", "124", fa, mg, mgb, bdata],
                       check=True, cwd=d, stdout=subprocess.DEVNULL)
    if not os.path.exists(fq):
        simulate_reads_fastq(fa, fq, num_reads, read_len=READ_LEN,
                             mm_poisson=1.2, mm_cap=4, indel_frac=0.12,
                             seed=13)
    return mgb, fq


def write_easy_inputs(d: str, num_reads: int,
                      genome_bp: int = EASY_BP) -> tuple[str, str]:
    """Write (once, cached in `d`) the 5 Mbp uniform-random world with 2-mm
    reads; returns (FASTA, reads FASTQ)."""
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq

    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "bench.fa")
    fq = os.path.join(d, f"reads_{num_reads}.fq")
    if not os.path.exists(fa):
        random_genome_fasta(fa, {"chr1": genome_bp}, seed=11)
    if not os.path.exists(fq):
        simulate_reads_fastq(fa, fq, num_reads, read_len=READ_LEN,
                             num_mm=2, seed=13)
    return fa, fq


def _load_or_build_index(fa: str, bwt: str, ref: str, ann: str):
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.index.fmindex import FMIndex

    if os.path.exists(bwt):
        return FMIndex.load(bwt)
    codes, _ann = fasta2ref(fa, ref, ann)
    idx = FMIndex.build(codes)
    idx.store(bwt)
    return idx


def build_world(hard: bool = False):
    """Build (once, cached) the chr21-scale multi-genome world; returns
    (FMIndex, Reads, world_dir)."""
    from bwbble_tpu.formats.fastq import read_fastq

    d = os.path.join(CACHE, "chr21_hard" if hard else "chr21")
    mgb, fq = write_chr21_inputs(d, NUM_READS, hard=hard)
    idx = _load_or_build_index(mgb, os.path.join(d, "mg_bubble.bwt"),
                               mgb + ".ref", mgb + ".ann")
    return idx, read_fastq(fq), d


def build_world_easy():
    """Secondary workload: 5 Mbp uniform random, 2 mm reads."""
    from bwbble_tpu.formats.fastq import read_fastq

    d = os.path.join(CACHE, "easy")
    fa, fq = write_easy_inputs(d, NUM_READS)
    idx = _load_or_build_index(fa, os.path.join(d, "bench.bwt"),
                               os.path.join(d, "bench.ref"),
                               os.path.join(d, "bench.ann"))
    return idx, read_fastq(fq), d


def main():
    easy = "--easy" in sys.argv
    hard = "--hard" in sys.argv
    # --single: BASELINE.json config 4 — plain 4-letter reference (-S),
    # the BWA-equivalent 1-to-1 search path (exact_match.c:181-222,
    # bwt.c:440-463) on the easy pure-ACGT world
    single = "--single" in sys.argv
    # --pre: BASELINE config with `-P` (12-mer precalc seeding,
    # align.c:200-238, main.c:113) on the easy world (NROOT > 1 seeds)
    pre = "--pre" in sys.argv
    t0 = time.time()
    if easy or single or pre:
        idx, reads, world = build_world_easy()
        fa = os.path.join(world, "bench.fa")
        fq_bench = os.path.join(world, f"reads_{NUM_READS}.fq")
        n_bench = reads.count
    else:
        idx, reads, world = build_world(hard=hard)
        from bwbble_tpu.formats.fastq import Reads
        n_bench = min(CHR21_BENCH_READS, reads.count)
        reads = Reads(names=reads.names[:n_bench], seq=reads.seq[:n_bench],
                      rc=reads.rc[:n_bench], qual=reads.qual[:n_bench],
                      lengths=reads.lengths[:n_bench])
        fa = os.path.join(world, "mg_bubble.fa")
        fq_bench = subset_fastq(os.path.join(world, f"reads_{NUM_READS}.fq"),
                                n_bench)
    baseline, oracle_aln = ensure_baseline(
        world, fa, fq_bench, n_bench,
        tag="_S" if single else "_P" if pre else "",
        align_args=("-n", "4", "-S") if single
        else ("-n", "4", "-P") if pre else ("-n", "4"))
    t_build = time.time() - t0

    import jax
    from bwbble_tpu.cli import enable_compilation_cache
    enable_compilation_cache()
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.inexact import EngineConfig
    from bwbble_tpu.engine.pipeline import align_reads_device
    from bwbble_tpu.formats.aln import write_aln_file

    def _ph(msg):
        sys.stderr.write(f"[bench +{time.time()-t0:.1f}s] {msg}\n")
        sys.stderr.flush()

    _ph(f"world + baseline ready ({t_build:.1f}s)")
    didx = from_fmindex(idx)
    _ph("device index uploaded")
    precalc = None
    if easy or single or pre:
        # easy-world configs run FIXED 8192-lane batches: per-read work is
        # tiny, so per-launch host overhead dominates the queued engine
        # here, while chr21's heavy reads amortize it.
        params = AlnParams(max_diff=4, batch_size=8192,
                           is_multiref=not single, use_precalc=pre)
        cfg = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)
        d_cap = 16
        if pre:
            from bwbble_tpu.align.precalc import load_or_build_precalc
            bwt = os.path.join(world, "bench.bwt")
            precalc = load_or_build_precalc(idx, params, bwt + ".pre",
                                            engine="device")
            _ph("precalc table ready")
    else:
        # chr21 multi-genome: 512 ring lanes at a 28.5K-pop per-read
        # budget (arena = cap x lanes x 512 B ~= 7.5 GB), carried over
        # untuned (ROADMAP C5).  Failures escalate through the queued
        # deep rung at the same arena memory.  D bounds need K=64
        # interval slots on IUPAC-dense references.
        params = AlnParams(max_diff=4, batch_size=512)
        cfg = EngineConfig(cap=655360, acap=24, kx=2, max_iters=500_000)
        d_cap = 64

    # Continuous batching on chr21 (hardest-first refill absorbs the
    # drain tail); the easy-world configs run fixed batches (see above).
    queued = not (easy or single or pre)
    qchunk = 16
    if not (easy or single or pre):
        idx.bit_planes()   # native gold rank substrate, built once

    # warm-up: one full pass compiles every shape (persistent-cached, so
    # the second bench invocation on a machine replays compilations)
    t_w0 = time.time()
    align_reads_device(idx, didx, reads, params, cfg, d_cap=d_cap,
                       queued=queued, qchunk=qchunk, precalc=precalc)
    t_warmup = time.time() - t_w0
    _ph(f"warm-up done ({t_warmup:.1f}s)")

    import resource
    stats: dict = {}
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    c0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t1 = time.time()
    alns = align_reads_device(idx, didx, reads, params, cfg, d_cap=d_cap,
                              stats=stats, queued=queued, qchunk=qchunk,
                              precalc=precalc)
    dt = time.time() - t1
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    c1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_main = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
    cpu_gold = (c1.ru_utime + c1.ru_stime) - (c0.ru_utime + c0.ru_stime)
    reads_per_sec = reads.count / dt

    # output parity vs the oracle's .aln on the same reads (byte equality)
    dev_aln = os.path.join(world, "device.aln")
    write_aln_file(dev_aln, alns)
    parity = filecmp.cmp(dev_aln, oracle_aln, shallow=False)

    n_aligned = sum(1 for a in alns if a)
    fallback = stats.get("fallback_reads", 0)
    t_dev = sum(t.get("sec", 0.0) for t in stats.get("tiers", [])) \
        or stats.get("t_search", 0.0)
    dev_reads = reads.count - fallback

    sys.stderr.write(
        f"backend={jax.default_backend()} workload="
        f"{'easy-5Mbp' if easy else 'single-5Mbp-S' if single else 'precalc-5Mbp-P' if pre else ('chr21-hard' if hard else 'chr21-multigenome')} "
        f"index_len={idx.length} build={t_build:.1f}s align={dt:.2f}s "
        f"aligned={n_aligned}/{reads.count} "
        f"end_to_end={reads_per_sec:.1f}r/s "
        f"device_tier={dev_reads}r/{t_dev:.2f}s"
        f"={dev_reads / t_dev if t_dev else 0:.1f}r/s "
        f"fallback={fallback} ({100.0 * fallback / reads.count:.2f}%) "
        f"baseline={baseline:.1f}r/s parity={parity} "
        f"retried={stats.get('retried_reads', 0)} "
        f"iters={stats.get('iters', 0)} "
        f"t_dbounds={stats.get('t_dbounds', 0):.2f}s "
        f"t_search={stats.get('t_search', 0):.2f}s "
        f"t_host={stats.get('t_host', 0):.2f}s "
        f"cpu_main={cpu_main:.1f}s cpu_gold={cpu_gold:.1f}s "
        f"prerouted={stats.get('prerouted', 0)} "
        f"t_warmup={t_warmup:.1f}s "
        f"waves={stats.get('waves', 0)} "
        f"tiers={stats.get('tiers', [])}\n")
    print(json.dumps({
        "metric": ("inexact_align_throughput_easy" if easy else
                   "single_genome_align_throughput" if single else
                   "precalc_seeded_align_throughput" if pre else
                   "chr21_multigenome_hard_align_throughput" if hard else
                   "chr21_multigenome_align_throughput"),
        "value": round(reads_per_sec, 1),
        "unit": "reads/s/chip",
        "vs_baseline": round(reads_per_sec / baseline, 3),
        "parity": parity,
        "t_warmup_s": round(t_warmup, 1),
    }))


if __name__ == "__main__":
    main()
