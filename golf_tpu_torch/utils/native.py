"""Host C++ DSP (counterpart of ``golf_tpu.utils.native``): the YIN f0
kernel and the windowed-sinc resampler of ``native/worldlite.cpp``, bound
with ctypes.

The library is the port's own: at first use ``native/worldlite.cpp`` is
compiled with ``g++`` and ``native/Makefile``'s flags into the git-ignored
``golf_tpu_torch/kernels/build/`` (named by a hash of the source, the
flags and the host, so an edited source rebuilds). ``native/*.so`` is
never read and ``make`` is never run there. A failed build raises: no call
falls back to numpy or scipy. ``dio(method="dio")`` is the numpy DIO of
``utils/world_lite.py``, as in ``golf_tpu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from . import world_lite

NATIVE = Path(__file__).resolve().parents[2] / "native"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build"
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(source: str) -> Path:
    """Where ``native/<source>`` is built: named by a hash of the source,
    the compiler, the flags and the host (``-march=native`` code runs only
    on a CPU like the one that built it)."""
    src = NATIVE / source
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((_cxx(),) + CXXFLAGS + (platform.node(),)).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def build_host_library(source: str) -> Path:
    """Compile ``native/<source>`` into ``kernels/build/`` unless it is
    there; raise with the compiler's output if the build fails."""
    lib = library_path(source)
    if lib.exists():
        return lib
    if shutil.which(_cxx()) is None:
        raise RuntimeError(f"{_cxx()} not found: native/{source} cannot be "
                           f"built")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([_cxx(), *CXXFLAGS, "-o", str(tmp),
                          str(NATIVE / source)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"building native/{source} failed:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load_host_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``native/<source>``, built at first use."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build_host_library(source)))
    return _LIBS[source]


def _worldlite() -> ctypes.CDLL:
    lib = load_host_library("worldlite.cpp")
    dp = ctypes.POINTER(ctypes.c_double)
    lib.wl_dio.restype = None
    lib.wl_dio.argtypes = [dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, dp,
                           ctypes.c_int]
    lib.wl_resample.restype = ctypes.c_int
    lib.wl_resample.argtypes = [dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                dp, ctypes.c_int]
    return lib


def dio(x: np.ndarray, fs: int, f0_floor: float = 65.0,
        f0_ceil: float = 1047.0, frame_period: float = 5.0,
        channels_in_octave: float = 2.0,
        method: str = "dio") -> Tuple[np.ndarray, np.ndarray]:
    """f0 estimation: ``method="dio"`` the numpy DIO
    (``world_lite.dio``), ``method="yin"`` the C++ YIN kernel."""
    x = np.ascontiguousarray(x, np.float64)
    if method == "dio":
        return world_lite.dio(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                              frame_period=frame_period,
                              channels_in_octave=channels_in_octave)
    lib = _worldlite()
    hop = int(fs * frame_period / 1000)
    n_frames = len(x) // hop + 1
    out = np.zeros(n_frames, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.wl_dio(x.ctypes.data_as(dp), len(x), fs, f0_floor, f0_ceil,
               frame_period, out.ctypes.data_as(dp), n_frames)
    t = np.arange(n_frames) * frame_period / 1000
    return out, t


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Windowed-sinc polyphase resampling in C++ (float64)."""
    if sr == target_sr:
        return np.asarray(x, np.float64)
    lib = _worldlite()
    x = np.ascontiguousarray(x, np.float64)
    out_len = int(len(x) * target_sr / sr) + 16
    out = np.zeros(out_len, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    n = lib.wl_resample(x.ctypes.data_as(dp), len(x), sr, target_sr,
                        out.ctypes.data_as(dp), out_len)
    return out[:n]


cheaptrick = world_lite.cheaptrick
d4c = world_lite.d4c
synthesize = world_lite.synthesize
get_f0 = world_lite.get_f0
