"""Multi-host runtime: two jax.distributed CPU
processes align disjoint read shards and the rank-0 merge must be
byte-identical to a single-process run."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cli(args, env, timeout=420):
    return subprocess.run(
        [sys.executable, "-m", "bwbble_tpu.cli"] + args,
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_two_process_merge_matches_single(tmp_path):
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.index import FMIndex
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq

    fa = str(tmp_path / "g.fa")
    fq = str(tmp_path / "r.fq")
    random_genome_fasta(fa, {"1": 40_000}, seed=9, iupac_frac=0.002)
    simulate_reads_fastq(fa, fq, 37, read_len=50, num_mm=2, seed=10)
    codes, _ = fasta2ref(fa, fa + ".ref", fa + ".ann")
    FMIndex.build(codes).store(fa + ".bwt")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    single = str(tmp_path / "single.aln")
    r = _run_cli(["align", "-n", "2", "--engine", "gold", fa, fq, single],
                 env)
    assert r.returncode == 0, r.stdout + r.stderr

    # two coordinated processes, same command line except the rank
    dist = str(tmp_path / "dist.aln")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwbble_tpu.cli", "align", "-n", "2",
         "--engine", "gold",
         "--dist", f"127.0.0.1:{port},2,{rank}", fa, fq, dist],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err

    with open(single, "rb") as f:
        a = f.read()
    with open(dist, "rb") as f:
        b = f.read()
    assert a == b
    assert not os.path.exists(dist + ".part0")
