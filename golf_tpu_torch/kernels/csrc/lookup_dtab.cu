// Bilinear wavetable lookup, table half of the adjoint (B3b).
//
// Replaces: golf_tpu/ops/lookup_pallas.py::_dtab_kernel, launched by
// bilinear_lookup_pallas_dtab (pallas_call at lookup_pallas.py:316).
//
// Computes, for ph (B, blocks, hop) in [0, 1) and the output cotangent
// g (B, blocks, hop), with col, c0, c1 (wrapping S to 0), cw and rw = i/hop
// as in the forward (lookup.cu), the per-block histogram
//   h[b, f, 0, c0] += g (1 - rw) (1 - cw),   h[b, f, 0, c1] += g (1 - rw) cw,
//   h[b, f, 1, c0] += g rw (1 - cw),         h[b, f, 1, c1] += g rw cw,
// written as (B, blocks, 2, S). Row 0 is block f's cotangent of table row f,
// row 1 its cotangent of row f + 1; the wrapper folds them into
// (B, frames, S) with two adds, as golf_tpu does outside its kernel
// (lookup_pallas.py:326-330). The corner weights are the expressions of
// lookup_pallas.py:146-149, built with --fmad=false so each product rounds
// as the plain version's; the order of the sums differs (atomics).
//
// What bounds it: bytes. Each sample reads its phase and its cotangent
// (8 bytes) and does ~20 flops and four shared-memory atomic adds; the
// histogram is written once per block. At the training shape
// (64, 20, 9600), S = 2048, that is ~109 MB counted against the
// (B, frames, S) result, about 33 us at 3.35 TB/s.
//
// Design: the TPU kernel builds one-hot matrices and scatters by matmul
// because the TPU has no vector scatter. Hopper has native shared-memory
// float atomics, so one CTA per (batch, block) keeps the block's 2 x S
// histogram (16 KB at S = 2048) in shared memory, strides over the hop
// samples with coalesced loads, adds the four corner weights with atomics
// and writes the histogram once. Neighbouring samples have neighbouring
// phases, so the atomics of a warp mostly hit different banks. The order of
// the atomic adds varies from run to run, so results agree with the plain
// version to a tolerance, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lookup_dtab_kernel(const float* __restrict__ ph, const float* __restrict__ g,
                   float* __restrict__ dtab, int blocks, int hop, int S) {
  extern __shared__ float hist[];  // [2 * S]: row f, then row f + 1
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * S; i += kThreads) hist[i] = 0.0f;
  __syncthreads();

  const size_t base = ((size_t)b * blocks + f) * (size_t)hop;
  const float sf = (float)S;
  const float hf = (float)hop;
  for (int i = threadIdx.x; i < hop; i += kThreads) {
    const float col = ph[base + i] * sf;
    const float c0f = fminf(fmaxf(floorf(col), 0.0f), sf - 1.0f);
    const int c0 = (int)c0f;
    const int c1 = (c0 + 1 == S) ? 0 : c0 + 1;
    const float cw = col - c0f;
    const float rw = __fdiv_rn((float)i, hf);
    const float gi = g[base + i];
    const float g0 = gi * (1.0f - rw);
    const float g1 = gi * rw;
    atomicAdd(&hist[c0], g0 * (1.0f - cw));
    atomicAdd(&hist[c1], g0 * cw);
    atomicAdd(&hist[S + c0], g1 * (1.0f - cw));
    atomicAdd(&hist[S + c1], g1 * cw);
  }
  __syncthreads();

  float* dst = dtab + ((size_t)b * blocks + f) * 2 * (size_t)S;
  for (int i = threadIdx.x; i < 2 * S; i += kThreads) dst[i] = hist[i];
}

}  // namespace

extern "C" int golf_lookup_dtab(const float* ph, const float* g, float* dtab,
                                int batch, int blocks, int hop, int S,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lookup_dtab_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(blocks, batch);
  lookup_dtab_kernel<<<grid, kThreads, smem, stream>>>(ph, g, dtab, blocks,
                                                        hop, S);
  return (int)cudaGetLastError();
}
