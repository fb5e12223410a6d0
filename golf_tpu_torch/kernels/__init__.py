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
While ``utils.profiling``'s recorder is on, each launch's C call is the
span ``kernel.<name>`` and ``build`` the span ``build.kernels``.
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

from ..utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
        # launches by operand shapes, kept until a caller clears it
        self.by_shapes: Dict[tuple, int] = {}
        self.span_name = f"kernel.{name}"
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
        ``shapes`` (the operands' shapes) is kept as ``last_shapes`` and
        counted in ``by_shapes``."""
        if self._fn is None:
            build([self])
        with profiling.span(self.span_name):
            rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1
        self.last_shapes = shapes
        self.by_shapes[shapes] = self.by_shapes.get(shapes, 0) + 1


def build(kernels: Iterable[CudaKernel], log: Optional[Dict] = None
          ) -> float:
    """Build (one ``nvcc`` per source, all started together) and bind every
    kernel whose library is missing; kernels that share a source share its
    library. Returns the wall time in seconds; ``log`` receives each build's
    compiler output (``-Xptxas -v``), by source."""
    with profiling.span("build.kernels"):
        return _build(kernels, log)


def _build(kernels: Iterable[CudaKernel], log: Optional[Dict]) -> float:
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

# the lookup's two entries also take the split planned by
# ops/lookup.py::plan_split (splits, piece)
LOOKUP = CudaKernel(
    "lookup", "lookup.cu", "golf_lookup_fwd",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], extra_flags=_NO_FMA)
LOOKUP_RES = CudaKernel(
    "lookup_res", "lookup.cu", "golf_lookup_fwd_res",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    extra_flags=_NO_FMA)
LOOKUP_DTAB = CudaKernel(
    "lookup_dtab", "lookup_dtab.cu", "golf_lookup_dtab",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], extra_flags=_NO_FMA)
ALLPOLE_CONST = CudaKernel(
    "allpole_const", "allpole_const.cu", "golf_allpole_const",
    [_P, _P, _P, _I, _I, _I, _I, _P])
ALLPOLE_CONST_ADJ = CudaKernel(
    "allpole_const_adjoint", "allpole_const.cu", "golf_allpole_const_adjoint",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
# the time-varying entries take the chunk length planned by
# ops/allpole.py::chunk_for and the chunks a CTA of phase 3 by rerun_chunks
ALLPOLE_TV = CudaKernel(
    "allpole_tv", "allpole_tv.cu", "golf_allpole_tv",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
ALLPOLE_TV_ADJ = CudaKernel(
    "allpole_tv_adjoint", "allpole_tv.cu", "golf_allpole_tv_adjoint",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
# the summary also keeps every chunk's map for the re-run entry, which
# runs the forward entry's carry and re-run from them; it takes the tree's
# group from ops/allpole.py::tree_group
ALLPOLE_TV_SUMMARY = CudaKernel(
    "allpole_tv_summary", "allpole_tv.cu", "golf_allpole_tv_summary",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
ALLPOLE_TV_RERUN = CudaKernel(
    "allpole_tv_rerun", "allpole_tv.cu", "golf_allpole_tv_rerun",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

# the encoder's conv pyramid stage: the convolution and bias, and the same
# with the eval stage (batch norm, ReLU, max-pool) in its epilogue; both
# take the tile planned by ops/pyramid.py::plan_conv (cog, rg, cg, chunk)
PYRAMID_CONV = CudaKernel(
    "pyramid_conv", "pyramid_conv.cu", "golf_pyramid_conv",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
PYRAMID_CONV_EVAL = CudaKernel(
    "pyramid_conv_eval", "pyramid_conv.cu", "golf_pyramid_conv_eval",
    [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, _I, _P])

ALL = (LOOKUP, LOOKUP_RES, LOOKUP_DTAB, ALLPOLE_CONST, ALLPOLE_CONST_ADJ,
       ALLPOLE_TV, ALLPOLE_TV_ADJ, ALLPOLE_TV_SUMMARY, ALLPOLE_TV_RERUN,
       PYRAMID_CONV, PYRAMID_CONV_EVAL)
