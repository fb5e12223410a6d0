// B1 and B3a as they were before their grid was split: one CTA of 256
// threads for each (batch, block), which copies rows f and f+1 of the
// table into shared memory, waits, then walks the block's hop samples with
// 4-byte loads and stores. The same arithmetic as
// golf_tpu_torch/kernels/csrc/lookup.cu (built with --fmad=false too).
//
// Not on any path of the port: chip_smoke.py and
// tools/lookup_split_sweep.py build it to time the split kernel against
// this one in the same run (``earlier_ms``).

#include <cuda_runtime.h>
namespace {

constexpr int kThreads = 256;

template <bool RES>
__global__ void __launch_bounds__(kThreads)
lookup_fwd_kernel(const float* __restrict__ ph,
                  const float* __restrict__ tables,
                  float* __restrict__ out, float* __restrict__ dtop,
                  float* __restrict__ dbot, int blocks, int hop, int frames,
                  int S) {
  extern __shared__ float rows[];  // [2 * S]: row f, then row f + 1
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const float* src = tables + ((size_t)b * frames + f) * (size_t)S;
  for (int i = threadIdx.x; i < 2 * S; i += kThreads) rows[i] = src[i];
  __syncthreads();

  const float* r0 = rows;
  const float* r1 = rows + S;
  const size_t base = ((size_t)b * blocks + f) * (size_t)hop;
  const float sf = (float)S;
  const float hf = (float)hop;
  for (int i = threadIdx.x; i < hop; i += kThreads) {
    const float col = ph[base + i] * sf;
    const float c0f = fminf(fmaxf(floorf(col), 0.0f), sf - 1.0f);
    const int c0 = (int)c0f;
    const int c1 = (c0 + 1 == S) ? 0 : c0 + 1;
    const float cw = col - c0f;
    const float v00 = r0[c0], v01 = r0[c1];
    const float v10 = r1[c0], v11 = r1[c1];
    const float top = v00 * (1.0f - cw) + v01 * cw;
    const float bot = v10 * (1.0f - cw) + v11 * cw;
    const float rw = __fdiv_rn((float)i, hf);
    out[base + i] = top * (1.0f - rw) + bot * rw;
    if (RES) {
      dtop[base + i] = v01 - v00;
      dbot[base + i] = v11 - v10;
    }
  }
}

template <bool RES>
int launch(const float* ph, const float* tables, float* out, float* dtop,
           float* dbot, int batch, int blocks, int hop, int frames, int S,
           int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lookup_fwd_kernel<RES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(blocks, batch);
  lookup_fwd_kernel<RES><<<grid, kThreads, smem, stream>>>(
      ph, tables, out, dtop, dbot, blocks, hop, frames, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int golf_lookup_unsplit_fwd(const float* ph,
                                       const float* tables, float* out,
                                       int batch, int blocks, int hop,
                                       int frames, int S, int device,
                                       cudaStream_t stream) {
  return launch<false>(ph, tables, out, nullptr, nullptr, batch, blocks, hop,
                       frames, S, device, stream);
}

extern "C" int golf_lookup_unsplit_fwd_res(const float* ph,
                                           const float* tables, float* out,
                                           float* dtop, float* dbot,
                                           int batch, int blocks, int hop,
                                           int frames, int S, int device,
                                           cudaStream_t stream) {
  return launch<true>(ph, tables, out, dtop, dbot, batch, blocks, hop,
                      frames, S, device, stream);
}
