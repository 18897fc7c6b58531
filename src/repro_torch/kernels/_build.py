"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under the
checkout's ``build/kernels/`` (listed in ``.gitignore``), keyed by a hash of
the sources and flags.  The library is loaded with ``ctypes``.  Every
function returns the ``cudaGetLastError()`` code of its launch, and
``repro_error_string`` (from ``csrc/common.cuh``) names it.

Compiling against PyTorch's headers (``torch.utils.cpp_extension.load``)
takes minutes per file; a plain C interface takes seconds.  Sources build
at first use, or all together (one ``nvcc`` each, in parallel) through
:func:`build`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

#: dynamic shared memory one block may use on the H100 (227 KB); every
#: wrapper refuses a tile or ring above it before any launch
SMEM_LIMIT = 232448

#: loaded libraries by source name; guarded by ``_LOCK``
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels")


def _cuobjdump() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("cuobjdump"), os.path.join(cuda_home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (PATH or $CUDA_HOME/bin)")


def sass_counts(name: str, opcodes: Iterable[str]) -> dict[str, int]:
    """How many times each opcode (``HGMMA``, ``UTMALDG``, ...) stands in the
    SASS of the built library of ``csrc/<name>.cu`` (``cuobjdump -sass``)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(build([name])[name])], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the library paths.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    The compiler's messages (``-Xptxas -v``) are kept beside each library
    as ``<library>.log``."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each exported function to ``(argtypes, restype)``;
    pointers and the stream must be ``ctypes.c_void_p`` or ctypes cuts
    them to 32 bits."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
