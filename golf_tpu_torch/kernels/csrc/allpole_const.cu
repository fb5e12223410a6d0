// Constant-coefficient all-pole filter, forward (GOLF-ff's end filter).
//
// Replaces: golf_tpu/ops/allpole_pallas.py::_const_kernel, launched by
// allpole_const_pallas (pallas_call at allpole_pallas.py:135).
//
// Computes y[n, t] = x[n, t] - sum_{i=1..p} a[n, i-1] y[n, t-i], zero
// initial state, for x (N, T) and a (N, p), rows time-contiguous.
//
// What bounds it: bytes, on paper. At the serving shape (N = 2400 frames of
// T = 960 samples, p = 22) it reads and writes ~18.4 MB (about 5.5 us at
// 3.35 TB/s) and does 2 p N T ~ 0.1 GFLOP. In practice the bound is the
// serial chain of T steps per row: N rows give only N / 32 warps, one per
// SM, each issuing ~2 p instructions per step.
//
// Design: one thread per row, its p coefficients and p-long state in
// registers (p is a template parameter; other orders up to 64 run a padded
// instantiation whose extra coefficients are zero). A thread reading its own
// row would not coalesce, so each warp stages a 32-row x 32-step tile of x
// through shared memory with 128-byte loads (row stride 33 floats keeps
// both access patterns free of bank conflicts), runs 32 steps of every
// row, and stores the outputs back the same way. The sum runs from the
// oldest state to the newest, so only the last FMA of a step waits on the
// step before.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;

template <int P, bool EXACT>
__global__ void __launch_bounds__(kTile)
allpole_const_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     float* __restrict__ y, int N, int T, int p) {
  __shared__ float tile[kTile][kTile + 1];
  const int lane = threadIdx.x;
  const int n0 = blockIdx.x * kTile;
  const int n = n0 + lane;
  const bool live = n < N;

  float c[P];
  float s[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    c[i] = (live && (EXACT || i < p)) ? a[(size_t)n * p + i] : 0.0f;
    s[i] = 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int steps = min(kTile, T - t0);
    for (int r = 0; r < kTile; ++r) {
      const int nr = n0 + r;
      tile[r][lane] = (nr < N && lane < steps)
                          ? x[(size_t)nr * T + t0 + lane] : 0.0f;
    }
    __syncwarp();
    // Steps past T run on zero input; their outputs are never stored and
    // no later tile follows them.
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      float acc = tile[lane][k];
#pragma unroll
      for (int i = P - 1; i >= 0; --i) acc = fmaf(-c[i], s[i], acc);
#pragma unroll
      for (int i = P - 1; i > 0; --i) s[i] = s[i - 1];
      s[0] = acc;
      tile[lane][k] = acc;
    }
    __syncwarp();
    for (int r = 0; r < kTile; ++r) {
      const int nr = n0 + r;
      if (nr < N && lane < steps) y[(size_t)nr * T + t0 + lane] = tile[r][lane];
    }
    __syncwarp();
  }
}

template <int P, bool EXACT>
cudaError_t launch(const float* x, const float* a, float* y, int N, int T,
                   int p, cudaStream_t stream) {
  const int grid = (N + kTile - 1) / kTile;
  allpole_const_kernel<P, EXACT><<<grid, kTile, 0, stream>>>(x, a, y, N, T, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int golf_allpole_const(const float* x, const float* a, float* y,
                                  int N, int T, int p, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p < 1) return (int)cudaErrorInvalidValue;
  if (p == 22) return (int)launch<22, true>(x, a, y, N, T, p, stream);
  if (p <= 8) return (int)launch<8, false>(x, a, y, N, T, p, stream);
  if (p <= 16) return (int)launch<16, false>(x, a, y, N, T, p, stream);
  if (p <= 32) return (int)launch<32, false>(x, a, y, N, T, p, stream);
  if (p <= 64) return (int)launch<64, false>(x, a, y, N, T, p, stream);
  return (int)cudaErrorInvalidValue;
}
