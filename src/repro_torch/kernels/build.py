"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale build is never loaded. Sources that are missing a build are compiled in parallel
(one ``nvcc`` process each, all started together) at first use; nothing
here runs at import, so importing this module needs no ``nvcc``. The build
directory is ``build/repro_torch`` at the repository root (listed in
``.gitignore``). ``ptxas``'s register and shared-memory report for each
source is kept beside its library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = [
    "SOURCES",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "nvcc_path",
    "build_all",
    "load",
    "check_launch",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {
    "feature_map": CSRC / "feature_map.cu",
    "logmatvec": CSRC / "logmatvec.cu",
    "kermatvec": CSRC / "kermatvec.cu",
    "fused_loop": CSRC / "fused_loop.cu",
    "paged": CSRC / "paged.cu",
}
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "repro_torch CUDA kernels are compiled at first use on a machine "
        "with the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256()
    headers = [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    for part in (src.read_bytes(), *headers, " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    return ``{name: library path}``. Raises with the compiler's output if
    any build fails."""
    paths = {name: _library_path(name) for name in SOURCES}
    missing = {n: p for n, p in paths.items() if not p.is_file()}
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in missing.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- {SOURCES[name].name} (nvcc exit "
                            f"{proc.returncode})\n{out}")
            continue
        Path(str(missing[name]) + ".log").write_text(out)
        os.replace(tmp, missing[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = ctypes.CDLL(str(build_all()[name]))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")
