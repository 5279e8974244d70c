"""Test configuration.

Tests run on the CPU: device-engine tests use a virtual 8-device CPU mesh,
so multi-device sharding is exercised without accelerators (set before JAX
initializes).  Tests that need a GPU carry the `gpu` marker and take the
`gpu` fixture, which skips them unless JAX's first device is a GPU; run
them on a card with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.

The native runtime (native/build/) is built once per session from the
committed sources, so the gold engine and the D-bound scanner that the
device pipeline uses are tested too.
"""

import fcntl
import os
import subprocess

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# pin the platform list even where an installed plugin registers another
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, ".oracle", "bwbble")
ORACLE_REF_SRC = "/root/reference/mg-aligner"


def _ensure_oracle() -> str | None:
    """Compile the reference aligner as a parity oracle if possible."""
    if os.path.exists(ORACLE):
        return ORACLE
    if not os.path.isdir(ORACLE_REF_SRC):
        return None
    os.makedirs(os.path.dirname(ORACLE), exist_ok=True)
    import glob
    srcs = glob.glob(os.path.join(ORACLE_REF_SRC, "*.c"))
    try:
        subprocess.run(
            ["gcc", "-O3", "-std=gnu99", "-fopenmp", *srcs, "-o", ORACLE,
             "-lm", "-lz", "-lpthread"],
            check=True, capture_output=True, cwd="/tmp")
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    return ORACLE if os.path.exists(ORACLE) else None


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture(scope="session", autouse=True)
def native_runtime():
    """Build native/build/ once: xdist workers take a file lock, so one
    compiles and the others find the finished library."""
    from bwbble_tpu import build_native, native
    lib = os.path.join(REPO, "native", "build", "libbwbble_native.so")
    os.makedirs(os.path.join(REPO, "native", "build"), exist_ok=True)
    with open(os.path.join(REPO, "native", "build", ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not (os.path.exists(lib) and os.path.exists(
                    os.path.join(REPO, "native", "build", "sam_pad"))):
                build_native.build(verbose=False)
        except (subprocess.CalledProcessError, OSError):
            pass        # tests that need the library skip without it
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    if native.get_native() is None:
        native._tried = False     # retry the load now that it is built
    return native.get_native()


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda on a "
                    "card)")
    return dev


@pytest.fixture(scope="session")
def oracle():
    path = _ensure_oracle()
    if path is None:
        pytest.skip("reference oracle binary unavailable")
    return path


@pytest.fixture(scope="session")
def small_world(tmp_path_factory):
    """A small indexed genome + simulated reads shared across tests."""
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index import FMIndex
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq

    d = tmp_path_factory.mktemp("world")
    fa = str(d / "g.fa")
    fq = str(d / "r.fq")
    random_genome_fasta(fa, {"chr1": 60_000, "chr2": 40_000}, seed=3,
                        iupac_frac=0.002)
    simulate_reads_fastq(fa, fq, 60, read_len=100, num_mm=2, seed=7)
    codes, ann = fasta2ref(fa, str(d / "g.fa.ref"), str(d / "g.fa.ann"))
    idx = FMIndex.build(codes)
    reads = read_fastq(fq)
    return {"dir": d, "fasta": fa, "fastq": fq, "codes": codes, "ann": ann,
            "idx": idx, "reads": reads}
