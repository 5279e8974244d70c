"""bwbble_tpu — a JAX multi-genome short-read aligner for one GPU or a host
of GPUs.

A from-scratch re-design of the capabilities of viq854/bwbble (BWT/FM-index
short-read alignment against a multi-genome: IUPAC-widened SNP reference plus
indel "bubbles") for an accelerator:

- host side (Python + C++): sequence/file-format codecs byte-compatible with the
  reference (`.ann`, `.ref`, `.bwt`, `.aln`, SAM), SA-IS index construction;
- device side (JAX/XLA): batched FM-index rank queries, lockstep
  exact/inexact backward-search engines, batched suffix-array resolution;
- parallel: data parallelism over reads via jax.sharding meshes, with a
  range-sharded index path for whole-genome scale.

Reference behavior is documented per-module with `mg-aligner/<file>:<lines>`
citations so parity can be audited. No reference code is copied.
"""

__version__ = "0.1.0"

from bwbble_tpu.align.params import AlnParams  # noqa: F401
