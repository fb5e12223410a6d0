// Time-varying all-pole filter, forward (GOLF-ss's end filter).
//
// Replaces: golf_tpu/ops/allpole_pallas.py::_kernel, launched by
// allpole_pallas (pallas_call at allpole_pallas.py:71).
//
// Computes y[b, t] = x[b, t] - sum_{i=1..p} a[b, t, i-1] y[b, t-i], zero
// initial state, for x (B, T) and a (B, T, p), all contiguous.
//
// What bounds it: on paper, bytes: a dominates, 4 B T p bytes (~50.6 MB at
// the serving shape B = 4, T = 143 761, p = 22; ~15 us at 3.35 TB/s). In
// practice, the serial chain: each sequence is T dependent steps, and at
// B = 4 only four sequences run on the whole card.
//
// Design: one warp per sequence. All 32 lanes stream the coefficients and
// the input through shared memory in chunks of kChunk steps with cp.async,
// double-buffered, so chunk c + 1 is in flight while lane 0 runs the
// recurrence over chunk c with its p-long state in registers; the warp
// then stores the chunk's outputs coalesced. The sum runs from the oldest
// state to the newest, so only the last FMA of a step waits on the step
// before. The chunked two-pass (blocked) form that would put more of the
// card to work at small B is left to a later redesign.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;

__device__ __forceinline__ void issue_chunk(const float* __restrict__ xb,
                                            const float* __restrict__ ab,
                                            float* sa, float* sx, int c,
                                            int T, int p, int lane) {
  const int t0 = c * kChunk;
  const int n = min(kChunk, T - t0);
  float* da = sa + (c & 1) * kChunk * p;
  float* dx = sx + (c & 1) * kChunk;
  const float* srca = ab + (size_t)t0 * p;
  for (int i = lane; i < n * p; i += 32)
    __pipeline_memcpy_async(da + i, srca + i, sizeof(float));
  for (int i = lane; i < n; i += 32)
    __pipeline_memcpy_async(dx + i, xb + t0 + i, sizeof(float));
  __pipeline_commit();
}

template <int P, bool EXACT>
__global__ void __launch_bounds__(32)
allpole_tv_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  float* __restrict__ y, int T, int p) {
  extern __shared__ float smem[];
  float* sa = smem;                      // [2][kChunk * p]
  float* sx = sa + 2 * kChunk * p;       // [2][kChunk]
  float* sy = sx + 2 * kChunk;           // [kChunk]
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * T;
  const float* ab = a + (size_t)b * T * p;
  float* yb = y + (size_t)b * T;
  const int nchunks = (T + kChunk - 1) / kChunk;

  float s[P];
#pragma unroll
  for (int i = 0; i < P; ++i) s[i] = 0.0f;

  issue_chunk(xb, ab, sa, sx, 0, T, p, lane);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue_chunk(xb, ab, sa, sx, c + 1, T, p, lane);
    } else {
      __pipeline_commit();  // empty group keeps the wait count uniform
    }
    __pipeline_wait_prior(1);  // chunk c has landed (this lane's copies)
    __syncwarp();              // ... and every other lane's
    const int t0 = c * kChunk;
    const int n = min(kChunk, T - t0);
    if (lane == 0) {
      const float* ca = sa + (c & 1) * kChunk * p;
      const float* cx = sx + (c & 1) * kChunk;
#pragma unroll 2
      for (int t = 0; t < n; ++t) {
        const float* at = ca + t * p;
        float acc = cx[t];
#pragma unroll
        for (int i = P - 1; i >= 0; --i) {
          const float ai = (EXACT || i < p) ? at[i] : 0.0f;
          acc = fmaf(-ai, s[i], acc);
        }
#pragma unroll
        for (int i = P - 1; i > 0; --i) s[i] = s[i - 1];
        s[0] = acc;
        sy[t] = acc;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) yb[t0 + i] = sy[i];
    __syncwarp();  // sy and this chunk's buffers are free again
  }
}

template <int P, bool EXACT>
cudaError_t launch(const float* x, const float* a, float* y, int B, int T,
                   int p, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)kChunk * p + 3 * kChunk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        allpole_tv_kernel<P, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  allpole_tv_kernel<P, EXACT><<<B, 32, smem, stream>>>(x, a, y, T, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int golf_allpole_tv(const float* x, const float* a, float* y,
                               int B, int T, int p, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p < 1) return (int)cudaErrorInvalidValue;
  if (p == 22) return (int)launch<22, true>(x, a, y, B, T, p, stream);
  if (p <= 8) return (int)launch<8, false>(x, a, y, B, T, p, stream);
  if (p <= 16) return (int)launch<16, false>(x, a, y, B, T, p, stream);
  if (p <= 32) return (int)launch<32, false>(x, a, y, B, T, p, stream);
  if (p <= 64) return (int)launch<64, false>(x, a, y, B, T, p, stream);
  return (int)cudaErrorInvalidValue;
}
