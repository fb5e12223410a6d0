"""ctypes binding of the native P.862 PESQ (counterpart of
``golf_tpu.utils.pesq862``).

``native/pesq862.cpp`` is the P.862/P.862.2 pipeline (level and crude
time alignment, Bark spectrum, Zwicker loudness, asymmetric disturbance,
L6/L2 aggregation, the MOS-LQO map) written from the published standard;
its scores are P.862-structured, not bit-identical to the ITU binary. It
is built at first use by ``utils.native.build_host_library`` into the
git-ignored ``golf_tpu_torch/kernels/build/``; a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .native import load_host_library

SOURCE = "pesq862.cpp"


def library() -> ctypes.CDLL:
    """The bound library, built at first use."""
    lib = load_host_library(SOURCE)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.pesq862_mos.restype = ctypes.c_double
    lib.pesq862_mos.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
    return lib


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int,
         mode: str = "wb") -> float:
    """MOS-LQO of ``deg`` against ``ref``; fs 8000 or 16000, mode ``wb``
    (P.862.2) or ``nb`` (P.862.1)."""
    lib = library()
    ref = np.ascontiguousarray(ref, np.float32).reshape(-1)
    deg = np.ascontiguousarray(deg, np.float32).reshape(-1)
    n = min(ref.shape[0], deg.shape[0])
    fp = ctypes.POINTER(ctypes.c_float)
    out = lib.pesq862_mos(ref[:n].ctypes.data_as(fp),
                          deg[:n].ctypes.data_as(fp),
                          n, fs, 1 if mode == "wb" else 0)
    if out < 0:
        raise ValueError("pesq862: unsupported input (too short or bad fs)")
    return float(out)
