"""Build the port's CUDA source with ``nvcc`` and load it with ``ctypes``.

The ``.cu`` under a kernel's ``csrc/`` has a plain C interface, so it
compiles in seconds without PyTorch's headers (no ``ninja`` needed).  The
shared library lands in ``kernels/_build/`` beside the sources, named by a
hash of the source and the flags, so an unchanged source is built once per
checkout.  A failed build raises with the compiler's output; nothing falls
back to the plain PyTorch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(repr((ARCH_FLAGS, NVCC_FLAGS)).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` into a shared library unless it is built already, then
    load it.  Raises with the compiler's output if ``nvcc`` fails."""
    src = Path(src)
    tgt = _target(src)
    if not tgt.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        p = subprocess.run(
            [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {p.returncode}):\n{p.stdout}")
        os.replace(tmp, tgt)
        tgt.with_suffix(".log").write_text(p.stdout)
    return ctypes.CDLL(str(tgt))
