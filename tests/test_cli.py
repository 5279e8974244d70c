"""End-to-end CLI tests: index -> align -> aln2sam with the reference's
command surface (main.c:72-160), gold engine vs device engine parity on the
emitted artifacts."""

import os

import numpy as np
import pytest

from bwbble_tpu.cli import main
from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    fa = str(d / "g.fa")
    fq = str(d / "r.fq")
    random_genome_fasta(fa, {"chrA": 30_000}, seed=21, iupac_frac=0.001)
    simulate_reads_fastq(fa, fq, 24, read_len=80, num_mm=1, seed=22)
    assert main(["index", fa]) == 0
    return {"dir": d, "fa": fa, "fq": fq}


def test_index_writes_artifacts(world):
    for ext in (".ref", ".ann", ".bwt"):
        assert os.path.exists(world["fa"] + ext)


def test_align_and_sam_gold(world):
    fa, fq = world["fa"], world["fq"]
    aln = str(world["dir"] / "gold.aln")
    sam = str(world["dir"] / "gold.sam")
    assert main(["align", "-n", "2", "--engine", "gold", fa, fq, aln]) == 0
    assert main(["aln2sam", fa, fq, aln, sam]) == 0
    lines = open(sam).read().splitlines()
    assert lines[0].startswith("@SQ")
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) == 24
    mapped = [l for l in body if l.split("\t")[1] != "4"]
    assert len(mapped) >= 20
    # simulated truth is encoded in read names: chrA_lpos_rpos_strand_...
    ok = 0
    for l in mapped:
        f = l.split("\t")
        truth = f[0].split("_")
        if f[2] == "chrA" and int(f[3]) == int(truth[1]):
            ok += 1
    assert ok >= len(mapped) - 2


def test_align_device_matches_gold_bytes(world):
    fa, fq = world["fa"], world["fq"]
    gold = str(world["dir"] / "gold.aln")
    dev = str(world["dir"] / "dev.aln")
    if not os.path.exists(gold):
        assert main(["align", "-n", "2", "--engine", "gold", fa, fq,
                     gold]) == 0
    assert main(["align", "-n", "2", "--batch", "24", fa, fq, dev]) == 0
    assert open(gold, "rb").read() == open(dev, "rb").read()


def test_index_esa(world, tmp_path):
    """`index -e` (40-bit external SA ingest, esa2bwt bwt.c:132-158) must
    produce a byte-identical .bwt to the in-RAM SA-IS build."""
    import shutil
    from bwbble_tpu.formats.fasta import read_ref
    from bwbble_tpu.index.suffix_array import suffix_array

    fa = str(tmp_path / "e.fa")
    shutil.copy(world["fa"], fa)
    assert main(["index", fa]) == 0
    ref_bwt = open(fa + ".bwt", "rb").read()

    codes = read_ref(fa + ".ref")
    sa = suffix_array(codes)  # rows 1..n of the full SA (row 0 is virtual)
    esa = tmp_path / "e.sa5"
    vals = sa.astype(np.uint64)
    raw = np.zeros((vals.shape[0], 5), dtype=np.uint8)
    for b in range(5):
        raw[:, b] = (vals >> (8 * b)) & 0xFF
    raw.tofile(esa)

    os.remove(fa + ".bwt")
    assert main(["index", "-e", str(esa), fa]) == 0
    assert open(fa + ".bwt", "rb").read() == ref_bwt


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compilation_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache lives at one fixed path inside the checkout."""
    import jax
    from bwbble_tpu import cli
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(repo, ".jax_cache")
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
            # what JAX itself takes from the variable at start-up
            jax.config.update("jax_compilation_cache_dir", env_dir)
            want = env_dir
        assert cli.enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
