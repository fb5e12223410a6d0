// Constant-coefficient all-pole filter (GOLF-ff's end filter) and its adjoint.
//
// Replaces: golf_tpu/ops/allpole_pallas.py::_const_kernel, launched by
// allpole_const_pallas (pallas_call at allpole_pallas.py:135), through
// golf_allpole_const; golf_allpole_const_adjoint replaces golf_tpu's VJP of
// it (golf_tpu/ops/allpole.py:395-405): the same kernel on the flipped
// cotangent, then p shifted dots for da, here in one pass.
//
// golf_allpole_const computes y[n, t] = x[n, t] - sum_{i=1..p} a[n, i-1]
// y[n, t-i] from a zero state, for x (N, T) and a (N, p), fp32, contiguous.
// golf_allpole_const_adjoint takes the cotangent g of y and computes
//   dx[n, t] = g[n, t] - sum_{i=1..p} a[n, i-1] dx[n, t+i]   (zero past T),
//   da[n, j] = -sum_t dx[n, t] y[n, t-j-1] = -sum_s y[n, s] dx[n, s+1+j],
// walking t from T - 1 down. Before step s the state holds dx[s+1..s+p],
// the very values da pairs with y[s], so da needs no look-ahead and no
// (N, T) temporary; g and y are read and dx written where they lie (no
// flipped copy). da may be skipped (a null pointer).
//
// What bounds it. On paper, bytes at the training shape (N = 12 800
// windows of T = 960, p = 22): the forward moves 99 MB (29.7 us at
// 3.35 TB/s), the adjoint 150 MB (44.7 us); the float64 work (2p flops a
// sample, 4p with da) is half that at 34 TFLOP/s. In practice the fp64
// pipe: one thread runs one row's T serial steps, so a warp issues p DFMAs
// a step (2p with da), and a sub-partition sustains one warp DFMA per ~3
// cycles when its three operands are distinct registers, whether it holds
// one warp or four (tools/allpole_const_probe.py). N rows make N / 32
// warps: 400 at training, 75 at serving (N = 2400), each with a
// sub-partition of its own, so both shapes take about one warp's T steps.
//
// Design:
//  - one thread per row, its coefficients (negated) and its state in
//    float64 registers; the state is a ring of p = 22 registers over groups
//    of 22 unrolled steps, so the ring's shift is register renaming. Orders
//    below 22 run the same kernel with zero coefficients; orders 23..64
//    keep coefficients, state and da sums in shared memory (right, not
//    tuned: no model runs them).
//  - float64 state and sums: on resonant filters (poles near the unit
//    circle) the float32 scan strays by up to a few percent of max|y|, the
//    float64 scan only by its final rounding (tools/allpole_resonance.py
//    --const). x, g, y and dx stay fp32 in memory.
//  - a one-FMA chain from step to step: a step's older taps (i >= 1), oldest
//    first, form a partial sum that does not wait on the step before; only
//    the newest tap does, so ptxas interleaves consecutive steps. More
//    partial sums only add DADDs: four were slower than one (PERF.md).
//  - loads in flight during the recurrence: each warp stages its 32 rows x
//    44 steps with cp.async (16-byte copies where T % 4 == 0, else 4-byte)
//    into one of two buffers, so the next tile lands while this one runs.
//    Outputs overwrite their inputs in the buffer and leave as coalesced
//    stores. A row is 44 floats (11 16-byte units), so the copies'
//    16-byte destinations stay aligned.
//  - one warp a CTA, working alone (no __syncthreads): at serving that puts
//    the 75 warps on 75 SMs (four-warp CTAs were no faster at training and
//    slower at serving, PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRing = 22;       // GOLF's order: the state in a register ring
constexpr int kMaxOrder = 64;
constexpr int kSteps = 44;      // steps a tile: two ring groups
constexpr int kTile = 32 * kSteps;

enum Mode { kForward = 0, kAdjoint = 1, kAdjointDa = 2 };

__host__ __device__ constexpr int tile_buffers(int mode) {
  return mode == kAdjointDa ? 4 : 2;  // two of the input (+ two of y)
}

// First step of tile k: forward tiles run up from 0, adjoint tiles down
// from T (the last one may start before 0).
template <bool ADJ>
__device__ __forceinline__ int tile_start(int T, int k) {
  return ADJ ? T - kSteps * (k + 1) : kSteps * k;
}

// Issues the copies of one tile: rows n0..n0+31, steps t0..t0+kSteps-1,
// row r at buf[r * kSteps]; elements outside the rows or [0, T) zero-fill
// (a copy of 0 bytes).
template <int VEC>
__device__ __forceinline__ void issue_tile(const float* __restrict__ src,
                                           float* buf, int n0, int N, int T,
                                           int t0, int lane) {
  constexpr int per_row = kSteps / VEC;
#pragma unroll 11
  for (int j = 0; j < per_row; ++j) {
    const int u = lane + 32 * j;
    const int r = u / per_row;
    const int c = (u - r * per_row) * VEC;
    const int t = t0 + c;
    const bool ok = n0 + r < N && t >= 0 && t + VEC <= T;
    __pipeline_memcpy_async(buf + r * kSteps + c,
                            ok ? src + (size_t)(n0 + r) * T + t : src,
                            4 * VEC, ok ? 0 : 4 * VEC);
  }
}

// Stores the elements of a tile that lie inside the rows and [0, T).
template <int VEC>
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* buf, int n0, int N,
                                           int T, int t0, int lane) {
  constexpr int per_row = kSteps / VEC;
#pragma unroll 11
  for (int j = 0; j < per_row; ++j) {
    const int u = lane + 32 * j;
    const int r = u / per_row;
    const int c = (u - r * per_row) * VEC;
    const int t = t0 + c;
    if (n0 + r < N && t >= 0 && t + VEC <= T) {
      float* d = dst + (size_t)(n0 + r) * T + t;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(d) =
            *reinterpret_cast<const float4*>(buf + r * kSteps + c);
      else
        *d = buf[r * kSteps + c];
    }
  }
}

// 22 steps on the register ring. Before step q, state component i (the
// output i + 1 steps back in walking order) is s[(q - 1 - i) mod 22]; step
// q overwrites s[q], the oldest. Step q reads its input at io[D q] and
// writes its output there (D = -1 walks the tile backwards); with da it
// also reads y at yv[D q]. c holds the negated coefficients. These scalar
// shared accesses at the row stride of 44 floats are 4-way bank conflicts;
// conflict-free 16-byte ones made the forward 3-7% slower and the adjoint
// 4% faster (PERF.md), so shared memory is not what holds B2 back.
template <int MODE>
__device__ __forceinline__ void ring_group(double (&s)[kRing],
                                           const double (&c)[kRing],
                                           double (&da)[kRing], float* io,
                                           const float* yv) {
  constexpr int D = MODE == kForward ? 1 : -1;
  float in[kRing];
  float yy[kRing];
#pragma unroll
  for (int q = 0; q < kRing; ++q) {
    in[q] = io[D * q];
    if constexpr (MODE == kAdjointDa) yy[q] = yv[D * q];
  }
#pragma unroll
  for (int q = 0; q < kRing; ++q) {
    if constexpr (MODE == kAdjointDa) {
      const double yq = (double)yy[q];
#pragma unroll
      for (int i = 0; i < kRing; ++i)
        da[i] = fma(yq, s[(q - 1 - i + 2 * kRing) % kRing], da[i]);
    }
    double older = (double)in[q];
#pragma unroll
    for (int i = kRing - 1; i >= 1; --i)
      older = fma(c[i], s[(q - 1 - i + 2 * kRing) % kRing], older);
    s[q] = fma(c[0], s[(q - 1 + kRing) % kRing], older);
    io[D * q] = (float)s[q];
  }
}

// Orders up to 22, one warp a CTA. x is the input (g for the adjoint), out
// the output (dx).
template <int MODE, int VEC>
__global__ void __launch_bounds__(32)
ring_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ a, float* __restrict__ out,
            float* __restrict__ da_out, int N, int T, int p) {
  constexpr bool ADJ = MODE != kForward;
  extern __shared__ __align__(16) float bufs[];
  const int lane = threadIdx.x;
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;
  const bool live = n < N;

  double c[kRing], s[kRing], da[kRing];
#pragma unroll
  for (int i = 0; i < kRing; ++i) {
    c[i] = (live && i < p) ? -(double)a[(size_t)n * p + i] : 0.0;
    s[i] = 0.0;
    da[i] = 0.0;
  }
  const int K = (T + kSteps - 1) / kSteps;
  auto issue = [&](int k) {
    if (k < K) {
      float* b = bufs + (k & 1) * kTile;
      issue_tile<VEC>(x, b, n0, N, T, tile_start<ADJ>(T, k), lane);
      if constexpr (MODE == kAdjointDa)
        issue_tile<VEC>(y, b + 2 * kTile, n0, N, T, tile_start<ADJ>(T, k),
                        lane);
    }
    __pipeline_commit();  // an empty group keeps the wait count uniform
  };

  issue(0);
  issue(1);
  for (int k = 0; k < K; ++k) {
    __pipeline_wait_prior(1);             // tile k has landed (own copies)
    __syncwarp();                         // ... and the warp's
    float* b = bufs + (k & 1) * kTile;
    float* row = b + lane * kSteps;
    // steps past T (forward) or before 0 (adjoint) run on zero input and
    // zero y; their outputs are never stored and no tile follows them
#pragma unroll 1
    for (int g0 = 0; g0 < kSteps; g0 += kRing) {
      const int col = ADJ ? kSteps - 1 - g0 : g0;
      ring_group<MODE>(s, c, da, row + col, row + 2 * kTile + col);
    }
    __syncwarp();                         // outputs in the buffer
    store_tile<VEC>(out, b, n0, N, T, tile_start<ADJ>(T, k), lane);
    __syncwarp();                         // buffer read: free for tile k + 2
    issue(k + 2);
  }
  if constexpr (MODE == kAdjointDa) {
    if (live) {
#pragma unroll
      for (int i = 0; i < kRing; ++i)
        if (i < p) da_out[(size_t)n * p + i] = (float)(-da[i]);
    }
  }
}

// Orders 23..64: one warp a CTA; coefficients, a 64-long state ring and da
// sums per thread in shared memory ([i][lane], conflict-free), one sum a
// step, oldest tap first.
template <int MODE>
size_t window_smem() {
  const int arrays = MODE == kAdjointDa ? 3 : 2;
  return (size_t)arrays * kMaxOrder * 32 * sizeof(double) +
         (size_t)tile_buffers(MODE) * kTile * sizeof(float);
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(32)
window_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ a, float* __restrict__ out,
              float* __restrict__ da_out, int N, int T, int p) {
  constexpr bool ADJ = MODE != kForward;
  constexpr bool DA = MODE == kAdjointDa;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  double* cs = reinterpret_cast<double*>(smem_raw);
  double* ring = cs + kMaxOrder * 32;
  double* das = ring + kMaxOrder * 32;
  float* bufs = reinterpret_cast<float*>(das + (DA ? kMaxOrder * 32 : 0));
  const int n0 = blockIdx.x * 32;
  const int n = n0 + lane;
  const bool live = n < N;
  for (int i = 0; i < kMaxOrder; ++i) {
    cs[i * 32 + lane] = (live && i < p) ? -(double)a[(size_t)n * p + i] : 0.0;
    ring[i * 32 + lane] = 0.0;
    if (DA) das[i * 32 + lane] = 0.0;
  }
  const int K = (T + kSteps - 1) / kSteps;
  auto issue = [&](int k) {
    if (k < K) {
      float* b = bufs + (k & 1) * kTile;
      issue_tile<VEC>(x, b, n0, N, T, tile_start<ADJ>(T, k), lane);
      if constexpr (DA)
        issue_tile<VEC>(y, b + 2 * kTile, n0, N, T, tile_start<ADJ>(T, k),
                        lane);
    }
    __pipeline_commit();
  };

  issue(0);
  issue(1);
  int m = 0;                              // steps walked
  for (int k = 0; k < K; ++k) {
    __pipeline_wait_prior(1);
    __syncwarp();
    float* b = bufs + (k & 1) * kTile;
    float* row = b + lane * kSteps;
    for (int q = 0; q < kSteps; ++q, ++m) {
      const int col = ADJ ? kSteps - 1 - q : q;
      double acc = (double)row[col];
      const double yq = DA ? (double)row[2 * kTile + col] : 0.0;
      for (int i = p - 1; i >= 0; --i) {
        const double si = ring[((m - 1 - i) & (kMaxOrder - 1)) * 32 + lane];
        acc = fma(cs[i * 32 + lane], si, acc);
        if (DA) das[i * 32 + lane] = fma(yq, si, das[i * 32 + lane]);
      }
      ring[(m & (kMaxOrder - 1)) * 32 + lane] = acc;
      row[col] = (float)acc;
    }
    __syncwarp();
    store_tile<VEC>(out, b, n0, N, T, tile_start<ADJ>(T, k), lane);
    __syncwarp();
    issue(k + 2);
  }
  if (DA && live)
    for (int i = 0; i < p; ++i)
      da_out[(size_t)n * p + i] = (float)(-das[i * 32 + lane]);
}

// ---------------------------------------------------------------------------

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int MODE, int VEC>
cudaError_t run(const float* x, const float* y, const float* a, float* out,
                float* da, int N, int T, int p, cudaStream_t stream) {
  cudaError_t err;
  if (p <= kRing) {
    const size_t smem = (size_t)tile_buffers(MODE) * kTile * sizeof(float);
    auto* k = ring_kernel<MODE, VEC>;
    if ((err = allow_smem((const void*)k, smem)) != cudaSuccess) return err;
    k<<<(N + 31) / 32, 32, smem, stream>>>(x, y, a, out, da, N, T, p);
  } else {
    const size_t smem = window_smem<MODE>();
    auto* k = window_kernel<MODE, VEC>;
    if ((err = allow_smem((const void*)k, smem)) != cudaSuccess) return err;
    k<<<(N + 31) / 32, 32, smem, stream>>>(x, y, a, out, da, N, T, p);
  }
  return cudaGetLastError();
}

// 16-byte copies where every row starts 16-byte aligned, else 4-byte.
template <int MODE>
int dispatch(const float* x, const float* y, const float* a, float* out,
             float* da, int N, int T, int p, int device,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p < 1 || p > kMaxOrder || N < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(y);
  if (T % 4 == 0 && bases % 16 == 0)
    return (int)run<MODE, 4>(x, y, a, out, da, N, T, p, stream);
  return (int)run<MODE, 1>(x, y, a, out, da, N, T, p, stream);
}

}  // namespace

extern "C" int golf_allpole_const(const float* x, const float* a, float* y,
                                  int N, int T, int p, int device,
                                  cudaStream_t stream) {
  return dispatch<kForward>(x, nullptr, a, y, nullptr, N, T, p, device,
                            stream);
}

// da (N, p) may be null: then only dx is computed and y is not read.
extern "C" int golf_allpole_const_adjoint(const float* g, const float* y,
                                          const float* a, float* dx,
                                          float* da, int N, int T, int p,
                                          int device, cudaStream_t stream) {
  if (da == nullptr)
    return dispatch<kAdjoint>(g, nullptr, a, dx, nullptr, N, T, p, device,
                              stream);
  return dispatch<kAdjointDa>(g, y, a, dx, da, N, T, p, device, stream);
}
