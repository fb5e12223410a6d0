#!/usr/bin/env python3
"""What limits B2 (``kernels/csrc/allpole_const.cu``) on the card.

    python tools/allpole_const_probe.py [--no-rate]

Two parts, both on one GPU:

* a float64 FMA rate probe: a kernel of 16 independent DFMA chains a
  thread, on 132 CTAs of 1, 2 or 4 warps a sub-partition, with three
  distinct register operands an FMA ("distinct") or two shared by every
  FMA ("shared", which the operand reuse cache can serve); it prints the
  SM clock (clock64 over the events' time) and the cycles a sub-partition
  takes per warp DFMA;
* B2 and its adjoint entry as built for the port, timed with CUDA events
  (``chip_smoke.cuda_ms``) at the training and serving shapes (N = 12 800
  and 2 400 windows of 960 samples, p = 22) and at N = 16 896 and 33 792
  (one and two warps a sub-partition of the 132 SMs), each with the
  cycles a warp DFMA takes at the SM clock the rate probe read.

Prints the card's name and power limit first. Needs ``nvcc`` and a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.ops import allpole as tap  # noqa: E402

SMS = 132

RATE_SOURCE = r"""
#include <cuda_runtime.h>
template <bool SHARED>
__global__ void dfma_rate(double* out, long long* cycles, int iters) {
  double a[16], b[16], c[16];
  const double t = threadIdx.x * 1e-6;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a[k] = t + k;
    b[k] = 1.0 + 1e-9 * (k + threadIdx.x);
    c[k] = 1e-9 * (k + 1 + threadIdx.x);
  }
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      a[k] = SHARED ? fma(a[k], b[0], c[0]) : fma(a[k], b[k], c[k]);
  }
  const long long t1 = clock64();
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int fp64_rate(double* out, long long* cycles, int iters,
                         int warps_per_sm, int shared, cudaStream_t stream) {
  if (shared)
    dfma_rate<true><<<%d, 32 * warps_per_sm, 0, stream>>>(out, cycles, iters);
  else
    dfma_rate<false><<<%d, 32 * warps_per_sm, 0, stream>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
""" % (SMS, SMS)


def fp64_rate_probe() -> float:
    """Prints each case's rate; returns the mean SM clock (GHz) it read."""
    src = kernels.BUILD / "fp64_rate_probe.cu"
    lib = kernels.BUILD / "fp64_rate_probe.so"
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    src.write_text(RATE_SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).fp64_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    iters = 20000
    stream = torch.cuda.current_stream().cuda_stream
    clocks = []
    for shared, per_sub in itertools.product((0, 1), (1, 2, 4)):
        warps = 4 * per_sub
        out = torch.empty(SMS * 32 * warps, dtype=torch.float64,
                          device="cuda")
        cyc = torch.empty(SMS, dtype=torch.int64, device="cuda")
        fn(out.data_ptr(), cyc.data_ptr(), 100, warps, shared, stream)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(out.data_ptr(), cyc.data_ptr(), iters, warps, shared, stream)
        stop.record()
        torch.cuda.synchronize()
        assert rc == 0, rc
        ms = start.elapsed_time(stop)
        cycles = cyc.double().mean().item()
        per_dfma = cycles / (iters * 16 * per_sub)
        clocks.append(cycles / ms / 1e6)
        print(f"fp64 rate: {'shared' if shared else 'distinct'} operands, "
              f"{per_sub} warp(s) a sub-partition: {ms:.3f} ms, SM clock "
              f"{cycles / ms / 1e6:.3f} GHz, {per_dfma:.2f} cycles a "
              f"sub-partition per warp DFMA ({2 * 16 * 32 / per_dfma:.0f} "
              f"flops a cycle an SM)")
    return sum(clocks) / len(clocks)


def b2_times(clock_ghz: float) -> None:
    kernels.build([kernels.ALLPOLE_CONST, kernels.ALLPOLE_CONST_ADJ])
    for n in (12800, 2400, 16896, 33792):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, 960), generator=gen, device="cuda")
        a = chip_smoke.lpc_coeffs(gen, (n, 22), "cuda")
        g = torch.randn((n, 960), generator=gen, device="cuda")
        y = tap.allpole_const_cuda(x, a)
        fwd_ms = chip_smoke.cuda_ms(lambda: tap.allpole_const_cuda(x, a), 50)
        adj_ms = chip_smoke.cuda_ms(
            lambda: tap.allpole_const_adjoint_cuda(g, y, a), 50)
        per_sub = -(-(n // 32) // (4 * SMS))  # warps a sub-partition
        line = (f"B2, N={n}: forward {fwd_ms * 1e3:.1f} us, adjoint "
                f"{adj_ms * 1e3:.1f} us")
        if clock_ghz:
            cyc = fwd_ms * 1e6 * clock_ghz / (960 * 22 * per_sub)
            line += (f"; forward {cyc:.2f} cycles a warp DFMA at the rate "
                     f"probe's {clock_ghz:.3f} GHz ({per_sub} warp(s) a "
                     f"sub-partition)")
        print(line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-rate", action="store_true",
                    help="skip the fp64 rate probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("allpole_const_probe: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.phase_environment()
    clock_ghz = 0.0 if args.no_rate else fp64_rate_probe()
    b2_times(clock_ghz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
