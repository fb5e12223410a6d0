// The encoder's conv pyramid stage, forward: Conv2d((2s + 1, 3), padding
// (s, 1)) + bias over fp32 NCHW (B, Cin, F, T) -> (B, Cout, F, T) (P1,
// golf_pyramid_conv); and the same convolution with the eval stage in its
// epilogue (golf_pyramid_conv_eval): batch norm with the running
// statistics, ReLU and the floor max-pool by s over F, writing only
// (B, Cout, F // s, T). Rows at or beyond (F // s) s, which the pool
// discards, are never computed there.
//
// Replaces: no Pallas site. golf_tpu runs the pyramid (models/unet.py::
// ConvPyramid) as flax Convs under XLA; the port ran them through cuDNN,
// whose heuristics chose an FFT convolution for the fp32 forward at about
// 12% of the card's fp32 rate, and then ran batch norm, ReLU, a copy and a
// max over the full-resolution tensor as separate passes in eval.
//
// What bounds it: operations. At the recipe's training shapes (B = 64,
// T = 201, channels 1 -> 32 -> 64 -> 128 -> 256, s = 4) layers 2 to 4 are
// 181 GFLOP each, about 2.7 ms at 67 TFLOP/s fp32, against 210, 53 and 13
// MB of output. Layer 1 (Cin = 1) does 11.4 GFLOP and writes 844 MB: its
// output write bounds it (0.25 ms at 3.35 TB/s) in training; the eval
// entry writes a quarter of that and is bound by its operations again.
//
// Design: implicit GEMM on the CUDA cores (FFMA, fp32 in and out, no TF32)
// with the im2col done in shared memory.
//  - A CTA of 256 threads owns one batch row and a tile of 8 cog output
//    channels x rg s rows x cg C frames; threads are cog x rg x cg, the
//    frame group fastest. ops/pyramid.py::plan_conv chooses (cog, rg, cg,
//    chunk) from the shape and the SM count.
//  - It loops over Cin in chunks of `chunk` channels. Each chunk's input
//    tile, chunk x (rg s + 2 s) x (cg C + 2), and weight slab, chunk x
//    (2 s + 1) x 3 x 8 cog (the wrapper passes the weights as (Cin, KH, 3,
//    Cout)), are copied into shared memory with cp.async, double
//    buffered: the next chunk's copy is in flight while this one is summed.
//    The weights go in 16-byte copies (Cout % 4 == 0; else 4-byte), the
//    input in 4-byte copies, the CTA's threads on consecutive elements of
//    the tile; out-of-range rows, frames, channels and outputs are
//    zero-filled by the copy (src-size 0), which is the convolution's zero
//    padding. Copying a row a warp instead (lanes idle on rows narrower
//    than 32, a division a row, 4-byte weights) took the layers 2-4 from
//    4.1-4.5 ms to 5.4-6.4 ms on an H100.
//  - Each thread keeps 8 output channels x s rows x C frames in registers
//    (C = 8 / s, 2 at s = 3): 64 sums at s = 4. For each input channel it
//    walks the 2 s + 1 kernel rows with a rolling window of s input rows x
//    (C + 2) frames in registers, one new row (two 8-byte loads at s = 4)
//    a kernel row, and loads each tap's 8 weights as two 16-byte loads:
//    78 shared-memory loads to 1728 FFMA an input channel at s = 4.
//  - The s rows of a pool window are one thread's own registers, so the
//    eval epilogue normalises, pools and applies ReLU (relu(max) is
//    max(relu)) without leaving registers.
//  - Each output is summed in two levels in a fixed order: a partial sum
//    an input channel over its kernel rows and columns (2 s + 1 times 3
//    products), added to the total in input-channel order; then the bias
//    is added. The result is deterministic (no atomics, no split of the
//    sum over threads) and the same for every tile and batch. One fp32
//    chain over all Cin (2 s + 1) 3 products, at stage 4's 3456, stood
//    5.4x cuDNN's error from float64 at B = 64 (1.31e-5 against 2.42e-6 on
//    an H100); the second level needs 64 more registers and so one CTA an
//    SM (about 10% slower at stages 2-4). With one input channel (stage 1)
//    the partial is the total, so that instantiation keeps one chain and
//    two CTAs an SM.
//  - The bias-only entry stores frame pairs as 8 bytes where T is even.
//  - The kernel is templated on s (the kernel height 2 s + 1, the rows a
//    thread owns and the unrolled taps) and the sum's levels, instantiated
//    for s = 1 to 4 with both; s = 4 is the recipe's. A pool window has to lie in one thread's registers,
//    which fixes the rows a thread owns to s at compile time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCoThread = 8;  // output channels a thread owns
constexpr int kMaxS = 4;

// frames a thread owns: 8 pixels a thread where s divides 8
template <int S>
struct Shape {
  static constexpr int KH = 2 * S + 1;
  static constexpr int C = (S == 3) ? 2 : 8 / S;
  static constexpr int TAPS = KH * 3;
};

struct Args {
  const float* x;      // (B, Cin, F, T)
  const float* wt;     // (Cin, KH, 3, Cout)
  const float* bias;   // (Cout)
  const float* mean;   // eval: running mean, variance, weight, bias (Cout)
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
  float* y;            // (B, Cout, F, T) or eval (B, Cout, F // s, T)
  int cin, cout, f, t;
  int rows;            // conv rows computed: F, or (F // s) s in eval
  int fout;            // rows of y
  int cog, rg, cg, chunk, tiles_t;
};

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// floats of one stage, weights then input, rounded to 16 bytes
template <int S>
__host__ __device__ inline int stage_floats(int cog, int rg, int cg,
                                            int chunk) {
  using Sh = Shape<S>;
  const int w = chunk * Sh::TAPS * kCoThread * cog;
  const int x = chunk * (rg * S + 2 * S) * (cg * Sh::C + 2);
  return (w + x + 3) & ~3;
}

template <int S>
__device__ __forceinline__ void load_stage(const Args& a, float* st, int ci0,
                                           const float* xb, int f0, int t0,
                                           int co0) {
  using Sh = Shape<S>;
  const int co_tile = kCoThread * a.cog;
  const int rows_in = a.rg * S + 2 * S;
  const int w_cols = a.cg * Sh::C + 2;
  float* ws = st;
  float* xs = st + a.chunk * Sh::TAPS * co_tile;
  // weights: chunk x TAPS rows of co_tile output channels; rows (ci, tap)
  // are consecutive in the (Cin, KH, 3, Cout) layout. Where Cout % 4 == 0
  // a row is whole 16-byte pieces (co0 is a multiple of 8)
  const float* wsrc = a.wt + (size_t)ci0 * Sh::TAPS * a.cout + co0;
  const int w_rows = a.chunk * Sh::TAPS;
  if ((a.cout & 3) == 0) {
    const int q = co_tile >> 2;
    for (int e = threadIdx.x; e < w_rows * q; e += kThreads) {
      const int r = e / q;
      const int c = (e - r * q) << 2;
      const bool ok = ci0 + r / Sh::TAPS < a.cin && co0 + c < a.cout;
      copy16(ws + r * co_tile + c, ok ? wsrc + (size_t)r * a.cout + c : a.wt,
             ok);
    }
  } else {
    for (int e = threadIdx.x; e < w_rows * co_tile; e += kThreads) {
      const int r = e / co_tile;
      const int c = e - r * co_tile;
      const bool ok = ci0 + r / Sh::TAPS < a.cin && co0 + c < a.cout;
      copy4(ws + e, ok ? wsrc + (size_t)r * a.cout + c : a.wt, ok);
    }
  }
  // input: chunk x rows_in rows of w_cols frames, from row f0 - s and
  // frame t0 - 1, the CTA's threads over consecutive elements; each thread
  // steps its (channel, row, frame) by the CTA's width
  const int n = a.chunk * rows_in * w_cols;
  const int dr = kThreads / w_cols, dc = kThreads - dr * w_cols;
  int r = threadIdx.x / w_cols;
  int c = threadIdx.x - r * w_cols;
  int cl = r / rows_in;
  r -= cl * rows_in;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int fr = f0 - S + r, tt = t0 - 1 + c;
    const bool ok = ci0 + cl < a.cin && fr >= 0 && fr < a.f && tt >= 0 &&
                    tt < a.t;
    copy4(xs + e,
          ok ? xb + ((size_t)(ci0 + cl) * a.f + fr) * a.t + tt : a.x, ok);
    c += dc;
    r += dr;
    if (c >= w_cols) {
      c -= w_cols;
      ++r;
    }
    while (r >= rows_in) {
      r -= rows_in;
      ++cl;
    }
  }
}

template <int C>
__device__ __forceinline__ void load_row(float (&row)[C + 2],
                                         const float* p) {
#pragma unroll
  for (int k = 0; k < (C + 2) / 2; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(p + 2 * k);
    row[2 * k] = v.x;
    row[2 * k + 1] = v.y;
  }
}

// TWO: the two-level sum (Cin > 1); else one chain (Cin = 1)
template <int S, bool EVAL, bool TWO>
__global__ void __launch_bounds__(kThreads, TWO ? 1 : 2)
pyramid_conv_kernel(const Args a) {
  using Sh = Shape<S>;
  constexpr int C = Sh::C;
  constexpr int KH = Sh::KH;
  extern __shared__ __align__(16) float smem[];

  const int co_tile = kCoThread * a.cog;
  const int rows_in = a.rg * S + 2 * S;
  const int w_cols = a.cg * C + 2;
  const int stage = stage_floats<S>(a.cog, a.rg, a.cg, a.chunk);

  const int groups = a.rg * a.cg;
  const int tid = threadIdx.x;
  const int cogi = tid / groups;
  const int pg = tid - cogi * groups;
  const int rgi = pg / a.cg;
  const int cgi = pg - rgi * a.cg;

  const int tile_f = blockIdx.x / a.tiles_t;
  const int tile_t = blockIdx.x - tile_f * a.tiles_t;
  const int f0 = tile_f * a.rg * S;
  const int t0 = tile_t * a.cg * C;
  const int co0 = blockIdx.y * co_tile;
  const int b = blockIdx.z;
  const float* xb = a.x + (size_t)b * a.cin * a.f * a.t;

  using Tile = float[S][C][kCoThread];
  Tile acc, part;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int c = 0; c < kCoThread; ++c) acc[i][j][c] = 0.0f;
  // the sums an input channel's products go into
  Tile& sum = TWO ? part : acc;

  const int n_chunks = (a.cin + a.chunk - 1) / a.chunk;
  load_stage<S>(a, smem, 0, xb, f0, t0, co0);
  commit();
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks)
      load_stage<S>(a, smem + ((k + 1) & 1) * stage, (k + 1) * a.chunk, xb,
                    f0, t0, co0);
    commit();
    wait_all_but_one();
    __syncthreads();
    const float* st = smem + (k & 1) * stage;
    const float* wbase = st + cogi * kCoThread;
    const float* xbase = st + a.chunk * Sh::TAPS * co_tile +
                         rgi * S * w_cols + cgi * C;
#pragma unroll 1
    for (int ci = 0; ci < a.chunk; ++ci) {
      const float* wr = wbase + ci * Sh::TAPS * co_tile;
      const float* xr = xbase + ci * rows_in * w_cols;
      if (TWO) {
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j)
#pragma unroll
            for (int c = 0; c < kCoThread; ++c) part[i][j][c] = 0.0f;
      }
      // rolling window: input row r of the thread's rows lives in r % S
      float win[S][C + 2];
#pragma unroll
      for (int r = 0; r < S - 1; ++r) load_row<C>(win[r], xr + r * w_cols);
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
        load_row<C>(win[(kh + S - 1) % S], xr + (kh + S - 1) * w_cols);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float* wp = wr + (kh * 3 + kw) * co_tile;
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
          const float w[kCoThread] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < S; ++i)
#pragma unroll
            for (int j = 0; j < C; ++j) {
              const float v = win[(kh + i) % S][j + kw];
#pragma unroll
              for (int c = 0; c < kCoThread; ++c)
                sum[i][j][c] = fmaf(v, w[c], sum[i][j][c]);
            }
        }
      }
      if (TWO) {
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j)
#pragma unroll
            for (int c = 0; c < kCoThread; ++c) acc[i][j][c] += part[i][j][c];
      }
    }
    __syncthreads();
  }

  const int fb = f0 + rgi * S;
  const int tb = t0 + cgi * C;
  const int cb = co0 + cogi * kCoThread;
  if (!EVAL) {
    // 8-byte stores where every row starts 8-byte aligned (T even; tb and
    // C are even)
    const bool pairs = (a.t & 1) == 0;
#pragma unroll
    for (int c = 0; c < kCoThread; ++c) {
      const int co = cb + c;
      if (co >= a.cout) break;
      const float bv = a.bias[co];
      float* yc = a.y + ((size_t)b * a.cout + co) * a.f * a.t;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (fb + i >= a.f) break;
        float* yr = yc + (size_t)(fb + i) * a.t + tb;
        if (pairs && tb + C <= a.t) {
#pragma unroll
          for (int j = 0; j < C; j += 2)
            *reinterpret_cast<float2*>(yr + j) =
                make_float2(acc[i][j][c] + bv, acc[i][j + 1][c] + bv);
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j)
            if (tb + j < a.t) yr[j] = acc[i][j][c] + bv;
        }
      }
    }
  } else {
    const int fo = fb / S;
    if (fo >= a.fout) return;
#pragma unroll
    for (int c = 0; c < kCoThread; ++c) {
      const int co = cb + c;
      if (co >= a.cout) break;
      const float bv = a.bias[co];
      const float mu = a.mean[co];
      const float alpha = a.gamma[co] / sqrtf(a.var[co] + a.eps);
      const float beta = a.beta[co];
      float* yc = a.y + (((size_t)b * a.cout + co) * a.fout + fo) * a.t;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        // the max and ReLU keep a NaN, as torch's amax and relu do (fmaxf
        // would drop it)
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float v = fmaf((acc[i][j][c] + bv) - mu, alpha, beta);
          m = (v > m || v != v) ? v : m;
        }
        if (tb + j < a.t) yc[tb + j] = (m > 0.0f || m != m) ? m : 0.0f;
      }
    }
  }
}

template <int S, bool EVAL, bool TWO>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int co_tiles = (a.cout + kCoThread * a.cog - 1) / (kCoThread * a.cog);
  const int tiles_f = (a.rows + a.rg * S - 1) / (a.rg * S);
  const size_t smem =
      2 * (size_t)stage_floats<S>(a.cog, a.rg, a.cg, a.chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_conv_kernel<S, EVAL, TWO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles_f * a.tiles_t, co_tiles, batch);
  pyramid_conv_kernel<S, EVAL, TWO><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool EVAL, bool TWO>
int launch_s(const Args& a, int batch, int s, cudaStream_t stream) {
  switch (s) {
    case 1: return launch<1, EVAL, TWO>(a, batch, stream);
    case 2: return launch<2, EVAL, TWO>(a, batch, stream);
    case 3: return launch<3, EVAL, TWO>(a, batch, stream);
    default: return launch<4, EVAL, TWO>(a, batch, stream);
  }
}

template <bool EVAL>
int dispatch(Args& a, int batch, int s, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (s < 1 || s > kMaxS || a.cog * a.rg * a.cg != kThreads || a.chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int cols[kMaxS + 1] = {0, Shape<1>::C, Shape<2>::C, Shape<3>::C,
                               Shape<4>::C};
  a.tiles_t = (a.t + a.cg * cols[s] - 1) / (a.cg * cols[s]);
  return a.cin > 1 ? launch_s<EVAL, true>(a, batch, s, stream)
                   : launch_s<EVAL, false>(a, batch, s, stream);
}

}  // namespace

// y = conv2d(x, w, pad (s, 1)) + bias; wt is the weight as (Cin, 2 s + 1,
// 3, Cout); (cog, rg, cg, chunk) from ops/pyramid.py::plan_conv
extern "C" int golf_pyramid_conv(const float* x, const float* wt,
                                 const float* bias, float* y, int batch,
                                 int cin, int cout, int f, int t, int s,
                                 int cog, int rg, int cg, int chunk,
                                 int device, cudaStream_t stream) {
  Args a{x, wt, bias, nullptr, nullptr, nullptr, nullptr, 0.0f, y,
         cin, cout, f, t, f, f, cog, rg, cg, chunk, 0};
  return dispatch<false>(a, batch, s, device, stream);
}

// y = maxpool_s(relu(batch_norm_eval(conv2d(x, w, pad (s, 1)) + bias))),
// (B, Cout, F // s, T)
extern "C" int golf_pyramid_conv_eval(const float* x, const float* wt,
                                      const float* bias, const float* mean,
                                      const float* var, const float* gamma,
                                      const float* beta, float eps, float* y,
                                      int batch, int cin, int cout, int f,
                                      int t, int s, int cog, int rg, int cg,
                                      int chunk, int device,
                                      cudaStream_t stream) {
  const int fout = s > 0 ? f / s : 0;
  Args a{x, wt, bias, mean, var, gamma, beta, eps, y,
         cin, cout, f, t, fout * s, fout, cog, rg, cg, chunk, 0};
  return dispatch<true>(a, batch, s, device, stream);
}
