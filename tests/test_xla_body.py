"""The XLA search body (engine/inexact.py) against the host gold engine.

One case per engine configuration the device pipeline launches: a fixed
batch, an escalation-ladder deep tier, precalc-seeded searches (NROOT > 1
root rows per lane), single-genome (-S) search, continuous batching (ring
arena + flush/refill + flush-time path walks), and a search bounded by the
native unbounded-list D scanner on an IUPAC-dense world.  Every lane that
finishes without overflow must encode to the same `.aln` bytes as the gold
engine's alignments for that read; overflowed lanes are the pipeline's
gold-fallback set and must stay a minority.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.align.pipeline import align_read_gold
from bwbble_tpu.engine import device_index as DI
from bwbble_tpu.engine.inexact import (EngineConfig, inexact_search,
                                       inexact_search_queued, unpack_paths,
                                       walk_paths)
from bwbble_tpu.engine.pipeline import _calc_d_chunk, _reconstruct_path
from bwbble_tpu.formats.aln import encode_alns
from bwbble_tpu.formats.fastq import parse_fastq_bytes
from bwbble_tpu.gold.engine import Aln
from bwbble_tpu.index import FMIndex

B = 128


def _sim_world(d, name, iupac_frac, seed):
    """20 kbp genome through fasta2ref (fwd + IUPAC reverse complement, as
    the index is laid out, io.c:190-321) and 48 simulated 50 bp reads with
    two mismatches, 15% of them also carrying a short indel."""
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq
    fa, fq = str(d / f"{name}.fa"), str(d / f"{name}.fq")
    random_genome_fasta(fa, {"c1": 20_000}, seed=seed, iupac_frac=iupac_frac)
    simulate_reads_fastq(fa, fq, 48, read_len=50, num_mm=2, seed=seed + 1,
                         indel_frac=0.15)
    codes, _ = fasta2ref(fa, str(d / f"{name}.ref"), str(d / f"{name}.ann"))
    idx = FMIndex.build(codes)
    return idx, DI.from_fmindex(idx), read_fastq(fq)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Multi-genome: 1% IUPAC (SNP) positions."""
    return _sim_world(tmp_path_factory.mktemp("mg"), "mg", 0.01, 5)


@pytest.fixture(scope="module")
def world_sg(tmp_path_factory):
    """Single-genome (-S) world: pure-ACGT reference."""
    return _sim_world(tmp_path_factory.mktemp("sg"), "sg", 0.0, 15)


def _reads_fastq(frags) -> bytes:
    return "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(frags)).encode()


@pytest.fixture(scope="module")
def world_dense(tmp_path_factory):
    """Repeats plus a SNP on every sixth position: the device D pass
    overflows wholesale (the pipeline then scans D bounds natively) and
    exact-completion interval lists run dozens of intervals wide."""
    from bwbble_tpu.formats.fasta import fasta2ref
    rng = np.random.default_rng(991)
    base = rng.integers(0, 4, size=1500)
    blocks = []
    for rep in range(3):
        blk = base.copy()
        mut = rng.random(blk.size) < (0.02 * rep)
        blk[mut] = rng.integers(0, 4, size=int(mut.sum()))
        blocks.append(blk)
    acgt_codes = np.array([8, 4, 2, 1], dtype=np.uint8)
    codes = acgt_codes[np.concatenate(blocks)]
    snp = rng.random(codes.size) < 1 / 6.0
    other = acgt_codes[rng.integers(0, 4, size=codes.size)]
    codes = np.where(snp, codes | other, codes).astype(np.uint8)
    mask_to_char = {1: "T", 2: "G", 4: "C", 8: "A", 3: "K", 5: "Y",
                    6: "S", 9: "W", 10: "R", 12: "M", 7: "B", 11: "D",
                    13: "H", 14: "V", 15: "N"}
    d = tmp_path_factory.mktemp("dense")
    fa = d / "w.fa"
    fa.write_text(">c\n" + "".join(mask_to_char[int(m)] for m in codes)
                  + "\n")
    out_codes, _ = fasta2ref(str(fa), str(d / "w.ref"), str(d / "w.ann"))
    idx = FMIndex.build(out_codes)
    L = 48
    frags = []
    for _ in range(32):
        s = int(rng.integers(0, base.size - L))
        frag = ["ACGT"[int(x)] for x in base[s:s + L]]
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        frags.append("".join(frag))
    return idx, DI.from_fmindex(idx), parse_fastq_bytes(_reads_fastq(frags))


def _pad(a, n):
    """[count, ...] padded to n rows with copies of row 0."""
    out = np.repeat(np.asarray(a[:1]), n, axis=0)
    out[:a.shape[0]] = a
    return out


def _device_d(didx, seq, lengths, params):
    """Device D bounds (K=16) of the forward reads and their overflow
    flags (calculate_d scans the read itself, inexact_match.c:36)."""
    D, Ds, dov = _calc_d_chunk(didx, jnp.asarray(seq), jnp.asarray(lengths),
                               lengths, params, K=16)
    return D, Ds, np.asarray(dov)


def _native_d(idx, reads, params):
    from bwbble_tpu.engine.pipeline import native_scan_chunks
    from bwbble_tpu.native import get_native
    nat = get_native()
    if nat is None or not getattr(nat, "_has_calc_d", False):
        pytest.skip("native D scanner not built")
    D = np.zeros((B, reads.max_len + 1, 2), dtype=np.int32)
    Ds = np.zeros((B, int(params.seed_length) + 1, 2), dtype=np.int32)
    for gi, Dch, Dsch, _zc in native_scan_chunks(idx, reads, params, B):
        D[gi[0]:gi[-1] + 1] = Dch
        Ds[gi[0]:gi[-1] + 1] = Dsch
    D[reads.count:] = D[0]
    Ds[reads.count:] = Ds[0]
    return jnp.asarray(D), jnp.asarray(Ds), np.zeros(B, dtype=bool)


def _alns(res, b, path_rev, root_plen):
    return [Aln(score=int(res["o_score"][b, k]), L=int(res["o_L"][b, k]),
                U=int(res["o_U"][b, k]), num_mm=int(res["o_mm"][b, k]),
                num_gapo=int(res["o_go"][b, k]),
                num_gape=int(res["o_ge"][b, k]),
                num_snps=int(res["o_snp"][b, k]) & 0xFF,
                aln_length=int(res["o_len"][b, k]),
                path=_reconstruct_path(path_rev(b, k),
                                       int(res["o_plen"][b, k]),
                                       int(res["o_len"][b, k]), root_plen))
            for k in range(int(res["n_alns"][b]))]


def _fixed_alns(res, nreads, skip, nc, nroot, pathcap, root_plen):
    """Per-read Aln lists of a fixed-batch result (None = overflow)."""
    res = {k: np.asarray(v) for k, v in res.items()}
    ok = [b for b in range(nreads)
          if not (res["overflow"][b] or skip[b])]
    keys = [(b, k) for b in ok for k in range(int(res["n_alns"][b]))]
    paths = {}
    if keys:
        W = max(256, len(keys))
        lanes = np.zeros(W, dtype=np.int32)
        nodes = np.full(W, -1, dtype=np.int32)
        lanes[:len(keys)] = [b for b, _ in keys]
        nodes[:len(keys)] = [int(res["o_node"][b, k]) for b, k in keys]
        pr = np.asarray(walk_paths(res["arena"], jnp.asarray(lanes),
                                   jnp.asarray(nodes), nroot=nroot,
                                   nslot=1 + 2 * nc, nc=nc, pathcap=pathcap))
        paths = {key: pr[w] for w, key in enumerate(keys)}
    out = [None] * nreads
    for b in ok:
        out[b] = _alns(res, b, lambda b_, k: paths[(b_, k)], root_plen)
    return out


def _case_fixed(world, world_sg, world_dense, name):
    """(device per-read Alns or None, gold per-read Alns)."""
    cfg = EngineConfig(cap=16384, acap=24, kx=4, max_iters=20_000)
    seeds, precalc, root_plen, nroot = {}, None, 0, 1
    if name == "single_genome":
        idx, didx, reads = world_sg
        params = AlnParams(max_diff=3, batch_size=B, is_multiref=False)
    elif name == "native_d":
        idx, didx, reads = world_dense
        params = AlnParams(max_diff=3, batch_size=B)
        # kx wide enough for the completion lists of this world
        cfg = EngineConfig(cap=131072, acap=24, kx=32, max_iters=60_000)
    else:
        idx, didx, reads = world
        params = AlnParams(max_diff=3, batch_size=B)
    if name == "deep_tier":
        # the escalation ladder's tier shape (pipeline.py: acap >= 64,
        # kx 8, larger per-lane arena)
        cfg = EngineConfig(cap=16384, acap=64, kx=8, max_iters=20_000)
    rc = _pad(reads.rc, B)
    lengths = _pad(reads.lengths.astype(np.int32), B)
    if name == "native_d":
        D, Ds, dov = _native_d(idx, reads, params)
    else:
        D, Ds, dov = _device_d(didx, _pad(reads.seq, B), lengths, params)
    if name == "seeded":
        from bwbble_tpu.align.precalc import build_precalc_gold, read_indices
        K, S = 4, 128      # k=4 seeds: many root rows per lane
        params = AlnParams(max_diff=3, batch_size=B, use_precalc=True,
                           precalc_len=K)
        precalc = build_precalc_gold(idx, params, k=K)
        sL, sU, scnt, sover = precalc.lookup_batch(
            read_indices(rc, lengths, k=K), S)
        assert not sover.any() and int(scnt.max()) > 1
        seeds = dict(seed_L=jnp.asarray(sL), seed_U=jnp.asarray(sU),
                     seed_cnt=jnp.asarray(scnt))
        cfg = EngineConfig(cap=16384, acap=24, kx=4, max_iters=40_000)
        root_plen, nroot = K, S
    res = inexact_search(didx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds,
                         params, cfg, **seeds)
    nc = 11 if params.is_multiref else 4
    dev = _fixed_alns(res, reads.count, dov, nc, nroot,
                      reads.max_len + 32, root_plen)
    gold = [align_read_gold(idx, reads.seq[b], reads.rc[b],
                            int(reads.lengths[b]), params, precalc=precalc)
            for b in range(reads.count)]
    return dev, gold


def _case_queued(world):
    """384 reads (the world tiled 8x) streamed through 128 ring lanes:
    mid-run refills, ring wraps and flush-time path walks."""
    idx, didx, reads = world
    params = AlnParams(max_diff=3, batch_size=B)
    cfg = EngineConfig(cap=8192, acap=24, kx=4, max_iters=20_000, flush=16)
    rc = np.tile(np.asarray(reads.rc, dtype=np.int8), (8, 1))
    lengths = np.tile(reads.lengths.astype(np.int32), 8)
    D, Ds, dov = _device_d(didx, np.tile(reads.seq, (8, 1)), lengths, params)
    res = inexact_search_queued(didx, jnp.asarray(rc), jnp.asarray(lengths),
                                D, Ds, params, cfg, lanes=B)
    res = {k: np.asarray(v) for k, v in res.items()}
    paths = unpack_paths(res["paths"], reads.max_len + 32)
    n = rc.shape[0]
    dev = [None if (res["overflow"][r] or dov[r]) else
           _alns(res, r, lambda b_, k: paths[b_, k], 0) for r in range(n)]
    gold1 = [align_read_gold(idx, reads.seq[b], reads.rc[b],
                             int(reads.lengths[b]), params)
             for b in range(reads.count)]
    return dev, gold1 * 8


@pytest.mark.parametrize("case", ["fixed", "deep_tier", "seeded",
                                  "single_genome", "queued", "native_d"])
def test_xla_body_aln_parity_with_gold(world, world_sg, world_dense, case):
    if case == "queued":
        dev, gold = _case_queued(world)
    else:
        dev, gold = _case_fixed(world, world_sg, world_dense, case)
    done = [r for r, a in enumerate(dev) if a is not None]
    # the device must own most reads, or the parity check says little
    assert len(done) >= 0.75 * len(dev), f"{len(done)}/{len(dev)} resolved"
    assert sum(len(gold[r]) for r in done) > 0
    for r in done:
        assert encode_alns(dev[r]) == encode_alns(gold[r]), f"read {r}"
        assert dev[r] == gold[r], f"read {r}"
