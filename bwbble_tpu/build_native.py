"""Build the native C++ runtime: `python -m bwbble_tpu.build_native`.

Outputs land in native/build/ (gitignored).  Each file is compiled under a
temporary name and moved into place with os.replace, so a concurrent reader
never loads a half-written library."""

from __future__ import annotations

import os
import subprocess
import sys


def _compile(cmd_head: list[str], out: str, verbose: bool) -> None:
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [*cmd_head, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    out_dir = os.path.join(root, "native", "build")
    os.makedirs(out_dir, exist_ok=True)

    src = os.path.join(root, "native", "bwbble_native.cpp")
    out = os.path.join(out_dir, "libbwbble_native.so")
    _compile(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
              "-march=native", src], out, verbose)

    # mg-ref toolchain: one multi-call binary + the three tool names
    mgref = os.path.join(out_dir, "mgref")
    _compile(["g++", "-O3", "-std=c++17",
              os.path.join(root, "native", "mgref.cpp")], mgref, verbose)
    for tool in ("data_prep", "comb", "sam_pad"):
        link = os.path.join(out_dir, tool)
        if not os.path.lexists(link):
            tmp = f"{link}.tmp{os.getpid()}"
            os.symlink("mgref", tmp)
            os.replace(tmp, link)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
