"""Hand-written CUDA kernels for Hopper (sm_90a), built on first use.

Each source in ``csrc/`` exports one C entry point that takes raw device
pointers, sizes, the device index and a CUDA stream, launches its kernel
and returns ``cudaGetLastError()``. ``nvcc`` builds each source into its own
shared library under ``build/`` (named by a hash of the source and flags,
so an edited source rebuilds), and ``ctypes`` binds it. Nothing here runs
when the module is imported: the CPU tests import every module, and this
machine may have no ``nvcc``.

Each kernel keeps a plain-int launch count, raised by one on every launch
and nowhere else, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class CudaKernel:
    """One ``csrc/*.cu`` source, its shared library and its C entry point."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = ARCH_FLAGS + BASE_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.last_shapes: tuple = ()
        self._fn = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source_path.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD / f"{self.source_path.stem}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path) -> list:
        return [_nvcc(), *self.flags, "-o", str(out), str(self.source_path)]

    def _bind(self):
        lib = ctypes.CDLL(str(self.library_path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, *args, shapes: tuple = ()) -> None:
        """Call the C entry point; raise if the launch reported an error.
        ``shapes`` (the operands' shapes) is kept as ``last_shapes``."""
        if self._fn is None:
            build([self])
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1
        self.last_shapes = shapes


def build(kernels: Iterable[CudaKernel], log: Optional[Dict] = None
          ) -> float:
    """Build (one ``nvcc`` per source, all started together) and bind every
    kernel whose library is missing; kernels that share a source share its
    library. Returns the wall time in seconds; ``log`` receives each build's
    compiler output (``-Xptxas -v``), by source."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    pending: Dict[Path, list] = {}
    for k in kernels:
        if k._fn is None:
            pending.setdefault(k.library_path, []).append(k)
    procs = []
    for lib, group in pending.items():
        if lib.exists():
            for k in group:
                k._bind()
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(group[0].build_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((group, proc, tmp, lib))
    failed = []
    for group, proc, tmp, lib in procs:
        out, _ = proc.communicate()
        if log is not None:
            log[group[0].source] = out
        if proc.returncode != 0:
            failed.append(f"{group[0].source}:\n{out}")
            continue
        os.replace(tmp, lib)
        for k in group:
            k._bind()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


# no FMA contraction in the lookup kernels: they then round like the plain
# versions' separate multiplies and adds, bit for bit (B1, B3a) or up to the
# order of the atomic sums (B3b)
_NO_FMA = ("--fmad=false",)

LOOKUP = CudaKernel(
    "lookup", "lookup.cu", "golf_lookup_fwd",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], extra_flags=_NO_FMA)
LOOKUP_RES = CudaKernel(
    "lookup_res", "lookup.cu", "golf_lookup_fwd_res",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], extra_flags=_NO_FMA)
LOOKUP_DTAB = CudaKernel(
    "lookup_dtab", "lookup_dtab.cu", "golf_lookup_dtab",
    [_P, _P, _P, _I, _I, _I, _I, _I, _P], extra_flags=_NO_FMA)
ALLPOLE_CONST = CudaKernel(
    "allpole_const", "allpole_const.cu", "golf_allpole_const",
    [_P, _P, _P, _I, _I, _I, _I, _P])
ALLPOLE_TV = CudaKernel(
    "allpole_tv", "allpole_tv.cu", "golf_allpole_tv",
    [_P, _P, _P, _I, _I, _I, _I, _P])

ALL = (LOOKUP, LOOKUP_RES, LOOKUP_DTAB, ALLPOLE_CONST, ALLPOLE_TV)
