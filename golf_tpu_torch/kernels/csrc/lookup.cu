// Bilinear wavetable lookup, forward (GOLF's harmonic source), and the same
// forward with the residuals its adjoint needs.
//
// Replaces: golf_tpu/ops/lookup_pallas.py::_fwd_kernel, launched by
// bilinear_lookup_pallas (pallas_call at lookup_pallas.py:246), through
// golf_lookup_fwd (B1); and ::_fwd_res_kernel, launched by
// bilinear_lookup_pallas_res (pallas_call at lookup_pallas.py:276), through
// golf_lookup_fwd_res (B3a). Two entry points, two launches, one source.
//
// Computes, for ph (B, blocks, hop) in [0, 1) and tables (B, frames, S)
// with frames >= blocks + 1:
//   col = ph * S, c0 = clamp(floor(col), 0, S-1), cw = col - c0,
//   c1 = c0 + 1, wrapping S to 0,
//   top = T[f][c0] (1 - cw) + T[f][c1] cw, bot = the same on row f + 1,
//   out[b, f, i] = top (1 - rw) + bot rw, rw = i / hop;
// B3a also writes d_top = T[f][c1] - T[f][c0] and d_bot = T[f+1][c1] -
// T[f+1][c0], from which the phase cotangent is elementwise.
// These are the expressions of _lookup_blocks_jnp (models/synth.py:82-105),
// rw by division as there. Built with --fmad=false, so every product and
// sum rounds on its own, as the plain PyTorch version's separate ops do.
//
// What bounds it: bytes. Each sample reads its phase and writes its output
// (8 bytes; B3a 16) and does ~15 flops; the table rows are read once per
// block. At the serving shape (4, 60, 9600) with S = 2048 B1 moves ~20.4 MB,
// about 6 us at 3.35 TB/s; at the training shape (64, 20, 9600) B3a moves
// ~208 MB, about 62 us.
//
// Design: the TPU kernel is a two-level one-hot matmul only because the TPU
// has no vector gather. Hopper gathers from shared memory, so one CTA per
// (batch, block) stages rows f and f+1 (2 S floats, 16 KB at S = 2048) in
// shared memory once and strides over the hop samples with coalesced phase
// loads and output stores and four shared-memory gathers each. Any S is
// accepted (dynamic shared memory above 48 KB is opted into).

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

extern "C" int golf_lookup_fwd(const float* ph, const float* tables,
                               float* out, int batch, int blocks, int hop,
                               int frames, int S, int device,
                               cudaStream_t stream) {
  return launch<false>(ph, tables, out, nullptr, nullptr, batch, blocks, hop,
                       frames, S, device, stream);
}

extern "C" int golf_lookup_fwd_res(const float* ph, const float* tables,
                                   float* out, float* dtop, float* dbot,
                                   int batch, int blocks, int hop,
                                   int frames, int S, int device,
                                   cudaStream_t stream) {
  return launch<true>(ph, tables, out, dtop, dbot, batch, blocks, hop,
                      frames, S, device, stream);
}
