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
// rw by division as there, i the sample's index within its block. Built
// with --fmad=false, so every product and sum rounds on its own, as the
// plain PyTorch version's separate ops do.
//
// What bounds it: bytes. Each sample reads its phase and writes its output
// (8 bytes; B3a 16) and does ~15 flops; the table rows are read once per
// block. At the serving shape (4, 60, 9600) with S = 2048 B1 moves ~20.4 MB,
// about 6 us at 3.35 TB/s; at the training shape (64, 20, 9600) ~109 MB,
// about 33 us (B3a ~208 MB, 62 us); a push's window (4, 3, 9600) ~1 MB,
// 0.3 us, so there the launch and one round trip to memory set the time.
//
// Design: the TPU kernel is a two-level one-hot matmul only because the TPU
// has no vector gather. Hopper gathers from shared memory: a CTA stages
// rows f and f+1 (2 S floats, 16 KB at S = 2048) in shared memory and does
// four shared-memory gathers a sample.
//  - the grid: each (batch, block) is split over `splits` CTAs, each taking
//    `piece` contiguous samples of the block (the last one the rest).
//    ops/lookup.py::plan_split chooses the split from the shape and the SM
//    count: at least one CTA a SM, otherwise pieces of about S samples,
//    in whole 16-byte units when hop % 4 == 0.
//  - 16-byte I/O: where hop and the piece are multiples of 4 and the
//    pointers 16-byte aligned, phases are loaded and outputs (and B3a's
//    residuals) stored as float4, streaming (evict-first) so that the table
//    rows stay in L2; any other shape runs the scalar path of the same
//    kernel.
//  - the rows do not stall the CTA: they are copied with cp.async (16-byte
//    copies where S % 4 == 0, else 4-byte), and the CTA's first phase loads
//    are issued before it waits for them.
// Any S is accepted (dynamic shared memory above 48 KB is opted into).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// CTAs an SM holds (32 registers a thread): ops/lookup.py plans waves with
// the same number
constexpr int kMinBlocks = 8;
// phase loads (float4 or float) a thread issues before it computes
constexpr int kBatch = 2;

// One sample of block f at index i within it: the output, and with RES the
// corner differences.
template <bool RES>
__device__ __forceinline__ float sample(float p, int i, const float* r0,
                                        const float* r1, int S, float sf,
                                        float hf, float& d_top,
                                        float& d_bot) {
  const float col = p * sf;
  const float c0f = fminf(fmaxf(floorf(col), 0.0f), sf - 1.0f);
  const int c0 = (int)c0f;
  const int c1 = (c0 + 1 == S) ? 0 : c0 + 1;
  const float cw = col - c0f;
  const float v00 = r0[c0], v01 = r0[c1];
  const float v10 = r1[c0], v11 = r1[c1];
  const float top = v00 * (1.0f - cw) + v01 * cw;
  const float bot = v10 * (1.0f - cw) + v11 * cw;
  const float rw = __fdiv_rn((float)i, hf);
  if (RES) {
    d_top = v01 - v00;
    d_bot = v11 - v10;
  }
  return top * (1.0f - rw) + bot * rw;
}

// VEC = 4: float4 I/O (hop and piece multiples of 4, pointers aligned);
// VEC = 1: scalar.
template <bool RES, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lookup_fwd_kernel(const float* __restrict__ ph,
                  const float* __restrict__ tables,
                  float* __restrict__ out, float* __restrict__ dtop,
                  float* __restrict__ dbot, int blocks, int hop, int frames,
                  int S, int splits, int piece, int stage16) {
  extern __shared__ __align__(16) float rows[];  // [2 S]: row f, row f + 1
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const int f = blockIdx.x / splits;
  const int start = (blockIdx.x - f * splits) * piece;
  const int n = min(piece, hop - start) / VEC;  // this CTA's units
  const int b = blockIdx.y;

  // rows f and f + 1 are 2 S contiguous floats
  const float* src = tables + ((size_t)b * frames + f) * (size_t)S;
  if (stage16) {
    for (int j = 4 * threadIdx.x; j < 2 * S; j += 4 * kThreads)
      __pipeline_memcpy_async(rows + j, src + j, 16);
  } else {
    for (int j = threadIdx.x; j < 2 * S; j += kThreads)
      __pipeline_memcpy_async(rows + j, src + j, 4);
  }
  __pipeline_commit();

  const float* r0 = rows;
  const float* r1 = rows + S;
  const size_t base = ((size_t)b * blocks + f) * (size_t)hop + start;
  const V* pin = reinterpret_cast<const V*>(ph + base);
  V* pout = reinterpret_cast<V*>(out + base);
  V* ptop = reinterpret_cast<V*>(dtop + (RES ? base : 0));
  V* pbot = reinterpret_cast<V*>(dbot + (RES ? base : 0));
  const float sf = (float)S;
  const float hf = (float)hop;
  bool staged = false;
  // every thread runs the same rounds (n is the CTA's), so the barrier in
  // the first is reached by all
  for (int r = 0; r < n; r += kBatch * kThreads) {
    V p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = r + u * kThreads + threadIdx.x;
      p[u] = v < n ? __ldcs(pin + v) : V{};
    }
    if (!staged) {  // the first phases are in flight: now wait for the rows
      __pipeline_wait_prior(0);
      __syncthreads();
      staged = true;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int v = r + u * kThreads + threadIdx.x;
      if (v >= n) continue;
      const int i = start + VEC * v;
      if constexpr (VEC == 4) {
        float4 o, t, d;
        o.x = sample<RES>(p[u].x, i, r0, r1, S, sf, hf, t.x, d.x);
        o.y = sample<RES>(p[u].y, i + 1, r0, r1, S, sf, hf, t.y, d.y);
        o.z = sample<RES>(p[u].z, i + 2, r0, r1, S, sf, hf, t.z, d.z);
        o.w = sample<RES>(p[u].w, i + 3, r0, r1, S, sf, hf, t.w, d.w);
        __stcs(pout + v, o);
        if (RES) {
          __stcs(ptop + v, t);
          __stcs(pbot + v, d);
        }
      } else {
        float t, d;
        __stcs(pout + v, sample<RES>(p[u], i, r0, r1, S, sf, hf, t, d));
        if (RES) {
          __stcs(ptop + v, t);
          __stcs(pbot + v, d);
        }
      }
    }
  }
}

template <bool RES, int VEC>
cudaError_t run(const float* ph, const float* tables, float* out,
                float* dtop, float* dbot, int batch, int blocks, int hop,
                int frames, int S, int splits, int piece, int stage16,
                cudaStream_t stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lookup_fwd_kernel<RES, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(splits * blocks, batch);
  lookup_fwd_kernel<RES, VEC><<<grid, kThreads, smem, stream>>>(
      ph, tables, out, dtop, dbot, blocks, hop, frames, S, splits, piece,
      stage16);
  return cudaGetLastError();
}

// The split must cover [0, hop) with `splits` non-empty pieces, and the
// grid (splits x blocks, batch) must be within CUDA's limits.
template <bool RES>
int launch(const float* ph, const float* tables, float* out, float* dtop,
           float* dbot, int batch, int blocks, int hop, int frames, int S,
           int splits, int piece, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch < 1 || batch > 65535 || blocks < 1 || hop < 1 || S < 1 ||
      frames < blocks + 1 || splits < 1 || piece < 1 ||
      (long long)splits * piece < hop ||
      (long long)(splits - 1) * piece >= hop ||
      (long long)splits * blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t io = reinterpret_cast<uintptr_t>(ph) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(dtop) |
                       reinterpret_cast<uintptr_t>(dbot);
  const int stage16 =
      S % 4 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0;
  if (hop % 4 == 0 && piece % 4 == 0 && io % 16 == 0)
    return (int)run<RES, 4>(ph, tables, out, dtop, dbot, batch, blocks, hop,
                            frames, S, splits, piece, stage16, stream);
  return (int)run<RES, 1>(ph, tables, out, dtop, dbot, batch, blocks, hop,
                          frames, S, splits, piece, stage16, stream);
}

}  // namespace

extern "C" int golf_lookup_fwd(const float* ph, const float* tables,
                               float* out, int batch, int blocks, int hop,
                               int frames, int S, int splits, int piece,
                               int device, cudaStream_t stream) {
  return launch<false>(ph, tables, out, nullptr, nullptr, batch, blocks, hop,
                       frames, S, splits, piece, device, stream);
}

extern "C" int golf_lookup_fwd_res(const float* ph, const float* tables,
                                   float* out, float* dtop, float* dbot,
                                   int batch, int blocks, int hop,
                                   int frames, int S, int splits, int piece,
                                   int device, cudaStream_t stream) {
  return launch<true>(ph, tables, out, dtop, dbot, batch, blocks, hop,
                      frames, S, splits, piece, device, stream);
}
