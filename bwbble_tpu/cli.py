"""`bwbble` command-line interface.

Reproduces the reference CLI surface (mg-aligner/main.c:72-160): subcommands
`index`, `align`, `fasta2ref`, `aln2sam` with the same single-letter flags and
positional arguments, and the same derived file names (`<fasta>.{ref,ann,bwt,
pre}`).  Device-engine extensions are long options only (--engine, --batch),
so every reference invocation works verbatim.

Run as `python -m bwbble_tpu ...` or via the `bwbble` wrapper script.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

import numpy as np


COMPILATION_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache (a cold `bwbble align` otherwise
    compiles every engine shape again); returns the directory in effect.
    JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and never
    overridden; otherwise the cache lives at one fixed path inside the
    checkout — the path is part of the cache key, so it must not move."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", COMPILATION_CACHE)
    return COMPILATION_CACHE


def _usage() -> int:
    print("Usage:   bwbble command [options]")
    print("Command: index    index sequences in the FASTA format")
    print("         align    exact or inexact read alignment")
    print("         fasta2ref    constructs a single linear reference "
          "from the input file")
    print("         aln2sam  convert alignment results to SAM file format "
          "for single-end mapping")
    return 1


def read_external_sa(path: str, n: int) -> np.ndarray:
    """Stream a 40-bit/entry external suffix array (eSAIS format) into the
    (n+1)-row full SA expected by FMIndex.build (esa2bwt, bwt.c:132-158):
    row 0 is the virtual total-'$' (value n), rows 1..n come from the file."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.shape[0] < 5 * n:
        raise ValueError(f"external SA file {path} too short: "
                         f"{raw.shape[0]} bytes < {5 * n}")
    raw = raw[:5 * n].reshape(n, 5).astype(np.int64)
    vals = (raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            | (raw[:, 3] << 24) | (raw[:, 4] << 32))
    return np.concatenate([np.array([n], dtype=np.int64), vals])


def cmd_index(argv: list[str]) -> int:
    from bwbble_tpu.formats.fasta import fasta2ref, read_ref
    from bwbble_tpu.index.fmindex import FMIndex

    try:
        opts, args = getopt.getopt(argv, "e:")
    except getopt.GetoptError as e:
        print(e)
        return 1
    if not args:
        print("Usage: bwbble index [options] <seq_fasta>")
        print("Options: e    file with the SA precomputed by the external "
              "memory eSAIS algorithm.")
        return 1
    esa = dict(opts).get("-e")
    fasta = args[0]
    print("**** BWT Index ****")
    t = time.time()
    if esa is None:
        codes, _ann = fasta2ref(fasta, fasta + ".ref", fasta + ".ann")
        idx = FMIndex.build(codes)
    else:
        codes = read_ref(fasta + ".ref")
        idx = FMIndex.build(codes, full_sa=read_external_sa(
            esa, codes.shape[0]))
    print(f"Total BWT construction time: {time.time() - t:.2f} sec")
    idx.store(fasta + ".bwt")
    return 0


def cmd_fasta2ref(argv: list[str]) -> int:
    from bwbble_tpu.formats.fasta import fasta2ref
    if not argv:
        print("Usage: bwbble fasta2ref <seq_fasta>")
        return 1
    fasta2ref(argv[0], argv[0] + ".ref", argv[0] + ".ann")
    return 0


def cmd_align(argv: list[str], stats: dict | None = None) -> int:
    """`bwbble align`.  In-process callers may pass `stats` to receive the
    device engine's counters (align_reads_device)."""
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.formats.aln import write_aln_file
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index.fmindex import FMIndex

    long_opts = ["engine=", "batch=", "arena=", "queued", "mesh=", "dist="]
    try:
        opts, args = getopt.gnu_getopt(argv, "M:O:E:n:k:o:e:l:m:t:SP",
                                       long_opts)
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 3:
        print("Usage: bwbble align [options] <seq_fasta> <reads_fastq> "
              "<output_aln>")
        return 1
    kw: dict = {}
    engine = "device"
    batch = None
    arena = None
    queued = False
    mesh_spec = None
    dist_spec = None
    for o, v in opts:
        if o == "-M":
            kw["mm_score"] = int(v)
        elif o == "-O":
            kw["gapo_score"] = int(v)
        elif o == "-E":
            kw["gape_score"] = int(v)
        elif o == "-n":
            kw["max_diff"] = int(v)
        elif o == "-k":
            kw["max_diff_seed"] = int(v)
        elif o == "-o":
            kw["max_gapo"] = int(v)
        elif o == "-e":
            kw["max_gape"] = int(v)
        elif o == "-l":
            kw["seed_length"] = int(v)
        elif o == "-m":
            kw["max_entries"] = int(v)
        elif o == "-t":
            kw["n_threads"] = int(v)
        elif o == "-S":
            kw["is_multiref"] = False
        elif o == "-P":
            kw["use_precalc"] = True
        elif o == "--engine":
            engine = v
        elif o == "--batch":
            batch = int(v)
        elif o == "--arena":
            arena = int(v)
        elif o == "--queued":
            queued = True
        elif o == "--mesh":
            mesh_spec = v
        elif o == "--dist":
            # --dist HOST:PORT,NPROCS,RANK — multi-host data parallelism
            # over reads (parallel/distributed.py); run one process per
            # host with the same command line except RANK
            dist_spec = v
    fasta, fastq, alnf = args[0], args[1], args[2]
    if batch is not None:
        kw["batch_size"] = batch
    params = AlnParams(**kw)

    print("**** BWBBLE Read Alignment ****")
    t = time.time()
    idx = FMIndex.load(fasta + ".bwt", load_sa=False)
    print(f"Total BWT loading time: {time.time() - t:.2f} sec")
    t = time.time()
    reads = read_fastq(fastq)
    print(f"Total read loading time: {time.time() - t:.2f} sec")

    dist_rank, dist_n = 0, 1
    if dist_spec is not None:
        from bwbble_tpu.parallel import distributed as DX
        coord, n_s, r_s = dist_spec.rsplit(",", 2)
        dist_n, dist_rank = int(n_s), int(r_s)
        DX.init(coord, dist_n, dist_rank)
        reads = DX.shard_reads(reads, dist_n, dist_rank)
        print(f"dist: process {dist_rank}/{dist_n} aligning "
              f"{reads.count} reads")

    precalc = None
    if params.use_precalc:
        from bwbble_tpu.align.precalc import load_or_build_precalc
        t = time.time()
        precalc = load_or_build_precalc(idx, params, fasta + ".pre",
                                        engine=engine)
        print("Total pre-calculated intervals loading time: "
              f"{time.time() - t:.2f} sec")

    t = time.time()
    if engine == "gold":
        # -t spreads reads over worker processes (the reference's OpenMP
        # read loop, inexact_match.c:92-168)
        from bwbble_tpu.engine.pipeline import gold_fallback_many
        got = gold_fallback_many(idx, reads, list(range(reads.count)),
                                 params, precalc, int(params.n_threads))
        alns = [got[i] for i in range(reads.count)]
    else:
        from bwbble_tpu.engine.device_index import from_fmindex
        from bwbble_tpu.engine.inexact import EngineConfig
        from bwbble_tpu.engine.pipeline import align_reads_device
        cfg = EngineConfig(cap=arena or int(params.arena_cap))
        mesh = None
        if mesh_spec is not None:
            # --mesh DP[,TP]: run the full sharded pipeline over a device
            # mesh (dp = read data-parallelism, tp = index range-sharding);
            # output is byte-identical to single-device alignment
            from bwbble_tpu.parallel.shard import make_mesh
            parts = [int(x) for x in mesh_spec.split(",")]
            mesh = make_mesh(parts[0], parts[1] if len(parts) > 1 else 1)
        alns = align_reads_device(idx, from_fmindex(idx), reads, params,
                                  cfg, precalc=precalc, queued=queued,
                                  mesh=mesh, stats=stats)
    print(f"Total read alignment time: {time.time() - t:.2f} sec")
    if dist_spec is not None:
        from bwbble_tpu.formats.aln import encode_alns
        from bwbble_tpu.parallel import distributed as DX
        DX.write_part(alnf, dist_rank,
                      b"".join(encode_alns(a) for a in alns))
        if dist_rank == 0:
            DX.merge_parts(alnf, dist_n)
    else:
        write_aln_file(alnf, alns)
    return 0


def cmd_aln2sam(argv: list[str]) -> int:
    from bwbble_tpu.align.pipeline import alns_to_sam
    from bwbble_tpu.formats.aln import read_aln_file
    from bwbble_tpu.formats.fasta import read_ann
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index.fmindex import FMIndex

    try:
        opts, args = getopt.gnu_getopt(argv, "n:So")
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 4:
        print("Usage: bwbble aln2sam [-S, -n] <seq_fasta> <reads_fastq> "
              "<alns_aln> <out_sam>")
        return 1
    max_diff = 6
    for o, v in opts:
        if o == "-n":
            max_diff = int(v)
    fasta, fastq, alnf, samf = args[:4]
    idx = FMIndex.load(fasta + ".bwt", load_sa=True)
    ann = read_ann(fasta + ".ann")
    reads = read_fastq(fastq)
    per_read = read_aln_file(alnf)
    # batched device SA resolution (lockstep invPsi walks,
    # engine/rank.py:sa_resolve; reference hot path bwt.c:320-329): the
    # host per-row loop is O(reads x 32 rank queries) in Python.  Indexes
    # of 2^31 positions or more need the int64 device layout (x64 mode),
    # so they resolve on the host.
    sa_resolver = device_sa_resolver(idx) if idx.length < 2**31 else None
    sam = alns_to_sam(idx, ann, reads, per_read, max_diff=max_diff,
                      sa_resolver=sa_resolver)
    with open(samf, "w") as f:
        f.write(sam)
    return 0


def device_sa_resolver(idx):
    """rows -> SA positions on the device (batched, padded to a power of
    two so repeated calls share compiled shapes)."""
    import jax.numpy as jnp
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.rank import sa_resolve
    didx = from_fmindex(idx)

    def resolve(rows):
        rows = np.asarray(rows, dtype=np.int64)
        n = rows.shape[0]
        if n == 0:
            return rows
        padded = np.zeros(max(256, 1 << (n - 1).bit_length()), np.int32)
        padded[:n] = rows
        out = np.asarray(sa_resolve(didx, jnp.asarray(padded)))
        return out[:n].astype(np.int64)

    return resolve


def cmd_eval(argv: list[str]) -> int:
    """Simulation-truth evaluation (eval_alns, align.c:655-722; not exposed
    by the reference CLI — a bwbble-tpu extension subcommand)."""
    from bwbble_tpu.align.evaluate import eval_alns
    from bwbble_tpu.formats.aln import read_aln_file
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index.fmindex import FMIndex

    try:
        opts, args = getopt.gnu_getopt(argv, "n:S")
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 3:
        print("Usage: bwbble eval [-S, -n] <seq_fasta> <reads_fastq> "
              "<alns_aln>")
        return 1
    is_multiref, max_diff = True, 6
    for o, v in opts:
        if o == "-S":
            is_multiref = False
        elif o == "-n":
            max_diff = int(v)
    print("**** BWBBLE Alignment Evaluation ****")
    idx = FMIndex.load(args[0] + ".bwt", load_sa=True)
    reads = read_fastq(args[1])
    eval_alns(idx, reads, read_aln_file(args[2]), is_multiref=is_multiref,
              max_diff=max_diff)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return _usage()
    cmd, rest = argv[0], argv[1:]
    if cmd in ("align", "aln2sam"):
        enable_compilation_cache()
    if cmd == "index":
        return cmd_index(rest)
    if cmd == "align":
        return cmd_align(rest)
    if cmd == "fasta2ref":
        return cmd_fasta2ref(rest)
    if cmd == "aln2sam":
        return cmd_aln2sam(rest)
    if cmd == "eval":
        return cmd_eval(rest)
    print(f"Error: Unknown command '{cmd}'")
    return _usage()


if __name__ == "__main__":
    sys.exit(main())
