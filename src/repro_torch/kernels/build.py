"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``.cu`` under a kernel's ``csrc/`` has a plain C interface, so it
compiles in seconds without PyTorch's headers (no ``ninja`` needed).  The
shared library lands in ``kernels/_build/`` beside the sources, named by a
hash of the source and the flags, so an unchanged source is built once per
checkout; ``load_many`` starts one ``nvcc`` per source, all together.  A
failed build raises with the compiler's output; nothing falls back to the
plain PyTorch path.  Every launch function returns a ``cudaError_t`` code,
which ``raise_on`` turns into an exception.  ``nvcc`` runs with ``-Xptxas
-v``; its output is kept beside the library and ``ptxas_usage`` reads the
registers and spills of each kernel from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

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


def _start(src: Path, tgt: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(src: Path, tgt: Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
    os.replace(tgt.with_suffix(f".{os.getpid()}.tmp"), tgt)
    tgt.with_suffix(".log").write_text(out)


def load_many(srcs) -> List[ctypes.CDLL]:
    """Build every source not built yet, all ``nvcc`` processes started
    together, then load them in order.  Raises with the first failing
    compiler's output once every build has ended."""
    srcs = [Path(s) for s in srcs]
    tgts = [_target(s) for s in srcs]
    procs = [(s, t, _start(s, t)) for s, t in zip(srcs, tgts)
             if not t.exists()]
    errors = []
    for s, t, proc in procs:
        try:
            _finish(s, t, proc)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return [ctypes.CDLL(str(t)) for t in tgts]


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` into a shared library unless it is built already, then
    load it.  Raises with the compiler's output if ``nvcc`` fails."""
    return load_many([src])[0]


def parse_ptxas(log: str) -> Dict[str, Tuple[int, int, int]]:
    """``{entry function: (registers, spill store bytes, spill load
    bytes)}`` of a ``ptxas -v`` report, mangled names as ptxas gives them."""
    usage, fn, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), *spills)
            fn = None
    return usage


def ptxas_usage(src: Path) -> Dict[str, Tuple[int, int, int]]:
    """``parse_ptxas`` of the report kept when ``src`` was built (build it
    first)."""
    return parse_ptxas(_target(Path(src)).with_suffix(".log").read_text())


def raise_on(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code (0 = launched).
    ``lib`` exports ``error_string(int)``."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def load_bound(src: Path, signatures) -> ctypes.CDLL:
    """``load(src)`` with ``error_string`` and each ``{name: argtypes}`` of
    ``signatures`` declared."""
    lib = load(src)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int      # a cudaError_t code, 0 = launched
    return lib


def check_cuda(name: str, *tensors, dtype=None) -> None:
    """The checks every wrapper makes before passing pointers: each tensor
    on one CUDA device, of ``dtype`` where given."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, expected {dev}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
