"""Multi-genome end-to-end: mgref comb -> index -> align -> aln2sam ->
sam_pad, with byte-parity against the reference toolchain on every artifact
(SURVEY.md §7 step 8)."""

import os
import subprocess

import numpy as np
import pytest

from bwbble_tpu.cli import main
from bwbble_tpu.testutil import random_genome_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MGREF = os.path.join(REPO, "native", "build", "mgref")


@pytest.fixture(scope="module")
def mg_world(tmp_path_factory):
    if not os.path.exists(MGREF):
        pytest.skip("native mgref not built")
    d = tmp_path_factory.mktemp("mg")
    fa = d / "ref.fa"
    rng = np.random.default_rng(99)
    random_genome_fasta(str(fa), {"9": 20_000}, seed=91)
    seq = "".join(l.strip() for l in open(fa) if not l.startswith(">"))

    # synthetic extracts: SNPs + one insertion (bubble)
    os.makedirs(d / "mg-ref-output", exist_ok=True)
    snp_pos = sorted(rng.choice(np.arange(200, 19_800), 60, replace=False))
    with open(d / "mg-ref-output" / "SNP.extract.chr9.data", "w") as f:
        for p in snp_pos:
            ref = seq[p - 1]
            alt = "ACGT"[("ACGT".find(ref) + 1) % 4]
            f.write(f"{p}\t{ref}\t{alt}\t5\n")
    ins_pos = 10_000
    with open(d / "mg-ref-output" / "INDEL.extract.chr9.data", "w") as f:
        f.write(f"{ins_pos}\t{seq[ins_pos - 1]}\t"
                f"{seq[ins_pos - 1]}GATTACA\t5\n")

    r = subprocess.run([MGREF, "comb", "-w", "40", str(fa), str(d / "mg.fa"),
                        str(d / "mgb.fa"), str(d / "bubble.data")],
                       cwd=d, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    # reads: one per SNP region (using the REF base), one inside the bubble
    # insertion, and some exact background reads
    reads = []
    for k, p in enumerate(snp_pos[:10]):
        reads.append((f"snp{k}", seq[p - 21:p + 19]))
    bubble_branch = (seq[ins_pos - 41:ins_pos] + "GATTACA"
                     + seq[ins_pos:ins_pos + 40])
    reads.append(("bub0", bubble_branch[20:60]))
    for k in range(5):
        s = int(rng.integers(0, 19_000))
        reads.append((f"bg{k}", seq[s:s + 40]))
    with open(d / "r.fq", "w") as f:
        for n, s in reads:
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")

    # our side of the pipeline, shared by every test of this module
    mgb, fq = str(d / "mgb.fa"), str(d / "r.fq")
    assert main(["index", mgb]) == 0
    assert main(["align", "-n", "2", mgb, fq, str(d / "g.aln")]) == 0
    assert main(["aln2sam", mgb, fq, str(d / "g.aln"), str(d / "g.sam")]) == 0
    return {"d": d, "snp_pos": snp_pos}


@pytest.fixture(scope="module")
def oracle_bin(oracle):
    return oracle


def test_multigenome_e2e_parity(mg_world, oracle_bin, tmp_path):
    d = mg_world["d"]
    mgb = str(d / "mgb.fa")
    fq = str(d / "r.fq")

    # oracle on a copy of the same inputs
    import shutil
    o = tmp_path
    shutil.copy(mgb, o / "o.fa")
    shutil.copy(fq, o / "o.fq")
    for cmd in ([oracle_bin, "index", "o.fa"],
                [oracle_bin, "align", "-n", "2", "o.fa", "o.fq", "o.aln"],
                [oracle_bin, "aln2sam", "o.fa", "o.fq", "o.aln", "o.sam"]):
        r = subprocess.run([str(c) for c in cmd], cwd=o, capture_output=True,
                           text=True)
        assert r.returncode == 0, r.stdout + r.stderr
    assert open(d / "g.aln", "rb").read() == open(o / "o.aln", "rb").read()
    assert open(d / "g.sam", "rb").read() == open(o / "o.sam", "rb").read()

    # the bubble read must align to a bubble sequence; lift it over
    sam_lines = [l for l in open(d / "g.sam") if not l.startswith("@")]
    bub = [l for l in sam_lines if l.startswith("bub0")]
    assert bub and bub[0].split("\t")[2].startswith("bubble")

    r = subprocess.run([MGREF, "sam_pad", str(d / "bubble.data"),
                        str(d / "g.sam"), str(d / "padded.sam")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    padded = [l for l in open(d / "padded.sam") if l.startswith("bub0")]
    assert "bC:Z:9" in padded[0] and "bP:Z:" in padded[0]


def test_snp_reads_align_through_iupac(mg_world):
    """Reads placed over SNP positions (carrying the REF base) must map at
    the right position on the IUPAC-coded multigenome."""
    d = mg_world["d"]
    sam_lines = [l.split("\t") for l in open(d / "g.sam")
                 if not l.startswith("@")]
    snps = [f for f in sam_lines if f[0].startswith("snp")]
    assert len(snps) == 10
    mapped = [f for f in snps if f[1] != "4"]
    assert len(mapped) >= 8
    snp_pos = mg_world["snp_pos"]
    for f in mapped:
        k = int(f[0][3:])
        assert f[2] == "9"
        assert int(f[3]) == int(snp_pos[k]) - 20