"""Build and load the port's hand-written CUDA kernels.

Each source ``src/repro_torch/csrc/<name>.cu`` has a plain C entry point.
It is compiled by ``nvcc`` for ``sm_90a`` (with ``csrc/`` on the include
path, for the shared ``*.cuh`` headers) into a shared library under the
repository's ``build/`` directory (listed in .gitignore) at first use,
named by a hash of the source, the headers and the flags
(``source_digest``), so an edited kernel or header is rebuilt, and loaded
with ``ctypes``.  Nothing here runs at import: the CPU tests import every
module of the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """The hash that names ``<name>``'s library: its ``.cu`` source, every
    ``*.cuh`` header beside it (a source may include any of them) and the
    compiler flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def nvcc_command(src, out) -> list:
    """The nvcc command that compiles ``src`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and the nvcc/ptxas output ("" when nothing
    was compiled); raises with that output if nvcc fails."""
    return build_all([name])[name]


def build_all(names) -> Dict[str, Tuple[Path, str]]:
    """`build` for several sources at once: one nvcc per source that is not
    up to date, all started together and all waited for (a failure raises
    after every compiler has exited)."""
    out: Dict[str, Tuple[Path, str]] = {}
    running = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        lib = BUILD / f"{name}-{source_digest(name)}.so"
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(src, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"kernel build failed: {name} (nvcc exit "
                          f"{proc.returncode})\n{text}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    return lib
