// Bilinear wavetable lookup, table half of the adjoint (B3b).
//
// Replaces: golf_tpu/ops/lookup_pallas.py::_dtab_kernel, launched by
// bilinear_lookup_pallas_dtab (pallas_call at lookup_pallas.py:316), with
// the fold of lookup_pallas.py:326-330.
//
// Computes, for ph (B, blocks, hop) in [0, 1) and the output cotangent
// g (B, blocks, hop), with col, c0, c1 (wrapping S to 0), cw and rw = i/hop
// as in the forward (lookup.cu), the table cotangent d (B, frames, S):
//   d[b, f, c0] += g (1 - rw) (1 - cw),   d[b, f, c1] += g (1 - rw) cw,
//   d[b, f + 1, c0] += g rw (1 - cw),     d[b, f + 1, c1] += g rw cw,
// for sample i of block f. The wrapper zeroes d. The corner weights are the
// expressions of lookup_pallas.py:146-149, built with --fmad=false so each
// product rounds as the plain version's; the order of the sums differs
// (atomics).
//
// What bounds it: bytes. Each sample reads its phase and its cotangent
// (8 bytes) and does ~20 flops; d is written once. At the training shape
// (64, 20, 9600), S = 2048, that is ~109 MB, about 33 us at 3.35 TB/s. In
// practice the shared-memory atomics (below).
//
// Design: the TPU kernel builds one-hot matrices and scatters by matmul
// because the TPU has no vector scatter. Here one CTA per (batch, block)
// keeps the block's two histogram rows in shared memory, interleaved as
// (row f, row f + 1) pairs per column, strides over the hop samples with
// coalesced loads and adds each sample's four corner weights there. It then
// adds the two rows straight into d[b, f] and d[b, f + 1] with global
// reductions (atomicAdd with its result unused: RED in the SASS); block
// f - 1 adds to row f too, so no per-block intermediate is written and no
// fold runs afterwards.
// The atomics: sm_90 has no native shared-memory fp32 add. cuobjdump -sass
// shows atomicAdd(float*) on shared memory as a compare-and-swap loop
// (ATOMS.CAST.SPIN), four loops a sample. The pairing adds a sample's two
// weights of one column in one 64-bit compare-and-swap loop (ATOMS.CAS.64),
// two a sample: each add still rounds on its own. Merging a thread's run of
// samples in registers does not help here: the phase moves S f0 / (4 sr)
// columns a sample, 1.3 to 21 at S = 2048 and 60 to 1000 Hz, so
// neighbouring samples rarely share a column. 512 threads a CTA put the
// 1280 (batch, block) units of the training shape in 2.4 waves of four
// CTAs an SM (256 threads: 1.2 waves); trial builds with 256 and 1024
// threads ran slower.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// adds (x, y) to the float pair at h with one 64-bit compare-and-swap loop
__device__ __forceinline__ void add_pair(float2* h, float x, float y) {
  unsigned long long* addr = reinterpret_cast<unsigned long long*>(h);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(
      addr);
  unsigned long long seen;
  do {
    seen = old;
    float2 v = *reinterpret_cast<const float2*>(&seen);
    v.x = v.x + x;
    v.y = v.y + y;
    old = atomicCAS(addr, seen, *reinterpret_cast<unsigned long long*>(&v));
  } while (old != seen);
}

__global__ void __launch_bounds__(kThreads)
lookup_dtab_kernel(const float* __restrict__ ph, const float* __restrict__ g,
                   float* __restrict__ dtab, int blocks, int hop, int frames,
                   int S) {
  extern __shared__ float2 hist[];  // [S]: (row f, row f + 1) per column
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < S; i += kThreads)
    hist[i] = make_float2(0.0f, 0.0f);
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
    add_pair(&hist[c0], g0 * (1.0f - cw), g1 * (1.0f - cw));
    add_pair(&hist[c1], g0 * cw, g1 * cw);
  }
  __syncthreads();

  float* row0 = dtab + ((size_t)b * frames + f) * (size_t)S;
  float* row1 = row0 + S;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float2 v = hist[i];
    atomicAdd(&row0[i], v.x);
    atomicAdd(&row1[i], v.y);
  }
}

}  // namespace

extern "C" int golf_lookup_dtab(const float* ph, const float* g, float* dtab,
                                int batch, int blocks, int hop, int frames,
                                int S, int device, cudaStream_t stream) {
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
                                                        hop, frames, S);
  return (int)cudaGetLastError();
}
