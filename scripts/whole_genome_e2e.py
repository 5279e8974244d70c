"""Whole-genome-scale int64 end-to-end exercise (>2^31 index positions).

Builds a real FM-index whose fwd+RC length exceeds int32 range (the reference's bwtint_t=uint64 regime, common.h:6),
entirely through the product path — FASTA -> fasta2ref -> SA-IS ->
FMIndex.store/load -> gold alignment -> SA resolution — and checks that
planted read positions are recovered.

Defaults to 1.55 Gbp fwd (3.1 G total positions ~ 1.44x int32 max).  The
full 6.4 G human-scale build needs ~150 GB RAM with the in-RAM SA-IS (the
reference points that case at its external eSAIS path, which we also
support via read_esa_40bit), so the >2^31 regime is what is exercised
here.

Runtime: dominated by single-core SA-IS over 3.1 G symbols.  The device
phase runs on the GPU and fails without one unless --cpu is given (host
gold only).

Usage: python scripts/whole_genome_e2e.py [--fwd-mbp 1550] [--dir DIR] [--cpu]
"""

import argparse
import json
import os
import sys
import time

import jax  # noqa: E402
# int64 index arithmetic end-to-end (reference bwtint_t = uint64,
# common.h:6); must be set before first JAX use.
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

LINE = 1 << 20  # FASTA line width (1 MiB; the reference reads char-by-char)


def gen_fasta(path: str, fwd_bp: int, seed: int, iupac_frac: float) -> None:
    """Stream a random IUPAC-bearing genome to disk in bounded memory."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    iupac = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b">chrW\n")
        left = fwd_bp
        while left > 0:
            n = min(LINE, left)
            block = acgt[rng.integers(0, 4, size=n)]
            k = rng.binomial(n, iupac_frac)
            if k:
                pos = rng.choice(n, size=k, replace=False)
                block[pos] = iupac[rng.integers(0, 10, size=k)]
            f.write(block.tobytes())
            f.write(b"\n")
            left -= n


def plant_reads(fa: str, fq: str, num: int, read_len: int, num_mm: int,
                seed: int) -> list[int]:
    """Sample fwd-strand substrings with <=num_mm mismatches; returns the
    planted 0-based fwd positions (ACGT-only windows)."""
    rng = np.random.default_rng(seed)
    with open(fa, "rb") as f:
        f.readline()
        text = f.read().replace(b"\n", b"")
    n = len(text)
    acgt = set(b"ACGT")
    positions = []
    with open(fq, "w") as f:
        while len(positions) < num:
            p = int(rng.integers(0, n - read_len))
            frag = bytearray(text[p:p + read_len])
            if any(c not in acgt for c in frag):
                continue
            for _ in range(num_mm):
                i = int(rng.integers(0, read_len))
                frag[i] = ord(rng.choice([c for c in "ACGT"
                                          if c != chr(frag[i])]))
            name = f"r{len(positions)}_pos{p}"
            f.write(f"@{name}\n{frag.decode()}\n+\n{'I' * read_len}\n")
            positions.append(p)
    return positions


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd-mbp", type=int, default=1550)
    ap.add_argument("--dir", default="wg_e2e",
                    help="work directory (default: ./wg_e2e)")
    ap.add_argument("--reads", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="skip the device phase (host gold only)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(f"whole_genome_e2e: no GPU (JAX backend "
                 f"{jax.default_backend()!r}); pass --cpu for the host-only "
                 f"run")

    d = args.dir
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "wg.fa")
    fq = os.path.join(d, "wg.fq")
    fwd_bp = args.fwd_mbp * 1_000_000
    report = {"fwd_bp": fwd_bp}

    if not os.path.exists(fa):
        t0 = time.time()
        gen_fasta(fa, fwd_bp, seed=5, iupac_frac=0.0005)
        print(f"gen_fasta: {time.time()-t0:.0f}s", flush=True)
    positions = plant_reads(fa, fq, args.reads, 100, 2, seed=6)
    print(f"planted {len(positions)} reads", flush=True)

    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.index import FMIndex

    bwt_path = os.path.join(d, "wg.bwt")
    if not os.path.exists(bwt_path):
        t0 = time.time()
        codes, ann = fasta2ref(fa, None, os.path.join(d, "wg.ann"))
        report["total_positions"] = int(codes.shape[0]) + 1
        print(f"fasta2ref: {time.time()-t0:.0f}s, "
              f"{codes.shape[0] + 1} positions "
              f"({(codes.shape[0] + 1) / 2**31:.2f}x int32 max)", flush=True)
        t0 = time.time()
        idx = FMIndex.build(codes)
        report["t_build_s"] = round(time.time() - t0, 1)
        print(f"FMIndex.build (SA-IS + occ): {report['t_build_s']}s",
              flush=True)
        del codes
        t0 = time.time()
        idx.store(bwt_path)
        print(f"store: {time.time()-t0:.0f}s "
              f"({os.path.getsize(bwt_path)/2**30:.2f} GiB)", flush=True)
    t0 = time.time()
    idx = FMIndex.load(bwt_path)
    report["t_load_s"] = round(time.time() - t0, 1)
    report["length"] = idx.length
    if fwd_bp >= 2**30:
        assert idx.length > 2**31, "index does not exceed int32 range"
    print(f"load: {report['t_load_s']}s, length={idx.length}", flush=True)

    # gold alignment (native engine if available) + SA resolution
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.align.pipeline import align_reads_gold
    from bwbble_tpu.formats.fastq import read_fastq

    reads = read_fastq(fq)
    params = AlnParams(max_diff=2)
    t0 = time.time()
    alns = align_reads_gold(idx, reads, params)
    report["t_align_s"] = round(time.time() - t0, 1)
    print(f"gold align {len(positions)} reads: {report['t_align_s']}s",
          flush=True)

    # ---- int64 device pass: upload the >2^31-position index in the int64
    # device layout and run the device engine on the same reads; every Aln
    # tuple must equal the host gold result.
    if not args.cpu:
        from bwbble_tpu.engine.device_index import from_fmindex
        from bwbble_tpu.engine.inexact import EngineConfig
        from bwbble_tpu.engine.pipeline import align_reads_device

        t0 = time.time()
        didx = from_fmindex(idx, use_int64=True)
        assert str(didx.idt) == "int64", didx.idt
        jax.block_until_ready(didx.table)
        report["t_device_upload_s"] = round(time.time() - t0, 1)
        print(f"device index uploaded (int64 layout, "
              f"{didx.table.nbytes / 2**30:.2f} GiB table): "
              f"{report['t_device_upload_s']}s", flush=True)
        dev_params = AlnParams(max_diff=2,
                               batch_size=max(16, len(positions)))
        dev_cfg = EngineConfig(cap=65536, acap=16, kx=2, max_iters=200_000)
        dstats: dict = {}
        t0 = time.time()
        dev_alns = align_reads_device(idx, didx, reads, dev_params,
                                      dev_cfg, d_cap=16, stats=dstats,
                                      gold_overlap=False)
        report["t_device_align_s"] = round(time.time() - t0, 1)
        report["device_fallback_reads"] = int(dstats.get("fallback_reads",
                                                         0))
        mism = 0
        for g_list, d_list in zip(alns, dev_alns):
            if len(g_list) != len(d_list):
                mism += 1
                continue
            for g, a in zip(g_list, d_list):
                if ((g.score, g.L, g.U, g.num_mm, g.num_gapo, g.num_gape,
                     g.num_snps, g.aln_length, g.path)
                        != (a.score, a.L, a.U, a.num_mm, a.num_gapo,
                            a.num_gape, a.num_snps, a.aln_length, a.path)):
                    mism += 1
        report["device_parity"] = mism == 0
        report["device_backend"] = str(jax.default_backend())
        print(f"device align (int64, {jax.default_backend()}): "
              f"{report['t_device_align_s']}s, mismatches={mism}, "
              f"fallback={report['device_fallback_reads']}", flush=True)
        assert mism == 0, "device int64 alignment diverged from gold"
    else:
        report["device_parity"] = None

    # resolve hits through the real SAM product path (SA walk + mapq +
    # coordinate projection) and compare reported POS to the plant
    from bwbble_tpu.align.pipeline import alns_to_sam
    from bwbble_tpu.formats.fasta import read_ann

    ann = read_ann(os.path.join(d, "wg.ann"))
    t0 = time.time()
    sam = alns_to_sam(idx, ann, reads, alns)
    report["t_sam_s"] = round(time.time() - t0, 1)
    hits = 0
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        fields = line.split("\t")
        name, flag, pos = fields[0], int(fields[1]), int(fields[3])
        if flag & 4:
            continue
        p0 = int(name.rsplit("_pos", 1)[1])
        if abs(pos - 1 - p0) <= 2:   # small indel slack
            hits += 1
        else:
            print(f"  {name}: planted {p0}, SAM pos {pos - 1}")
    report["reads_recovered"] = hits
    report["reads_total"] = len(positions)
    print(json.dumps(report))
    with open(os.path.join(d, "whole_genome_e2e.json"), "w") as f:
        json.dump(report, f, indent=1)
    assert hits >= len(positions) * 3 // 4, "too few planted reads recovered"
    print("whole-genome e2e: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
