// B4's three entries as they were before their redesign (the zi and
// summary entries' first design, and the forward and adjoint entries' of
// the chunked kernel), at the fixed chunk length the wrapper passed then
// (512): a forward with a nullable zi, its adjoint, and the summary, whose
// composition was one CTA a sequence multiplying the K chunk maps in turn
// from global memory. The same source as
// golf_tpu_torch/kernels/csrc/allpole_tv.cu had before, its entry points
// renamed.
//
// Not on any path of the port: chip_smoke.py and
// tools/allpole_chunk_sweep.py build it to time the redesigned entries
// against these in the same run (``earlier_ms``).
//
// Time-varying all-pole filter (GOLF-ss's end filter) and its adjoint.
//
// Replaces: golf_tpu/ops/allpole_pallas.py::_kernel, launched by
// allpole_pallas (pallas_call at allpole_pallas.py:71), through
// golf_allpole_tv; golf_allpole_tv_adjoint is the same filter on the
// transposed system, which golf_tpu runs as allpole_pallas on flipped,
// column-shifted coefficients (golf_tpu/ops/allpole.py:247-256).
//
// golf_allpole_tv computes y[b, t] = x[b, t] - sum_{i=1..p} a[b, t, i-1]
// y[b, t-i] for x (B, T) and a (B, T, p), fp32, contiguous, from the
// initial state y[b, -1 - i] = zi[b, i] (streaming: golf_tpu's
// allpole_stream, golf_tpu/ops/allpole.py:262-282, which runs the float32
// scan or blocked form there), or from a zero state where zi is null, as
// the Pallas kernel does. golf_allpole_tv_adjoint computes
// dx = flip(filter(flip(g), flip(c))) with c[n, j] = a[n + j + 1, j] (zero
// past the end) without building c or any flipped copy: in reversed step m
// tap j reads a[b, T - m + j, j] for j < m (zero otherwise), g is read and
// dx written at T - 1 - m. The two entries differ only in where a step's
// operands are read, so the adjoint equals the forward entry on the
// materialised operands bit for bit. golf_allpole_tv_summary returns a
// sequence's affine end-state map in float64 (the time-sharded filter's
// boundary exchange): phase 1 below over every chunk, the last included,
// then one CTA per sequence keeps the product of the chunk maps.
//
// Design: the chunked two-pass form, three kernels on the caller's stream.
// Steps (time, or reversed time) are cut into chunks of L (from the caller).
//  1. maps: one CTA per (sequence, chunk but the last). Thread c < p tracks
//     column c of the chunk's state map (the state's response to incoming
//     state component c), thread p its zero-state response; all read the
//     same coefficients from shared memory (a broadcast). Only the end map
//     M_k (p x p, stored by column) and offset v_k (p) are written, in
//     float64.
//  2. carry: one CTA per sequence runs s_{k+1} = M_k s_k + v_k in float64
//     over the chunks, thread i row i, the next maps prefetched with
//     cp.async into a ring of stages; it writes every chunk's incoming state.
//  3. re-run: one CTA per (sequence, chunk) runs the recurrence again from
//     its incoming state and writes y; all lanes run the same recurrence (a
//     warp instruction costs the same for one lane as for 32) and lane 0
//     writes. It is float64 too: in a trial of the plain mirror on the CPU,
//     a float32 re-run from the float64 state exceeded the float32 scan's
//     error on two of six uncapped resonant filters.
// Phases 1 and 3 share one kernel. A group of steps' taps and inputs are
// copied with cp.async (fp32) while the group before runs, then turned into
// float64 rows in shared memory in step order (the adjoint's gathered
// along the diagonal), so the recurrence reads the same values in the same
// order for both entries.
// Both recurrences work a group of steps at a time from shared memory. For
// GOLF's order (p = 22) the state is a ring of p registers and the group is
// p steps, unrolled, so the state's shift costs no moves; every other order
// up to 64 keeps a thread's state as a window in shared memory (a group of
// 8 steps, then the last p outputs move to the window's front), with
// p + 1 columns over 32, 64 or 96 threads in phase 1.
//
// Why float64 maps: the state map of a chunk is a product of L companion
// matrices. For the resonant filters GOLF-ss learns (rc2lpc(0.95 tanh(.)),
// poles near the unit circle) its entries span many orders of magnitude,
// and forming or composing it in float32 loses more than the float32
// sequential scan does (golf_tpu's float32 blocked form: errors from 7e-3
// of max|y| to overflow, against 2e-5 to 3e-2 for the float32 scan and
// below 2e-6 for this float64 form; tools/allpole_resonance.py).
//
// What bounds it, at the training shape (B = 64, T = 47 760, p = 22):
//  - bytes: a is read twice (phases 1 and 3), 2 x 269 MB, ~160 us at
//    3.35 TB/s; x, y and the maps (24 MB at L = 512) are small beside it;
//  - fp64 operations: phase 1 does p (p + 1) FMAs a sample, ~1.5 G FMA,
//    ~91 us at 34 TFLOP/s (lanes p + 1..31 idle: ~127 us); phase 3 p more;
//  - phase 3 issues p float64 FMAs a step per warp, as many warp
//    instructions as phase 1;
//  - phase 2's serial chain: ceil(T / L) - 1 dependent p x p products a
//    sequence.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRingOrder = 22;     // GOLF's order: the state in registers
constexpr int kWindowGroup = 8;    // steps a group with the state in smem

__host__ __device__ constexpr int group_steps(int P) {
  return P > 0 ? P : kWindowGroup;
}

// phase 2's prefetch depth: maps in flight ahead of the one in use
__host__ __device__ constexpr int carry_stages(int P) {
  return P <= 32 ? 8 : 4;
}

__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Where step s (absolute) reads its input and writes its output; its tap i
// reads row s (forward) or T - s + i (adjoint, zero at or past T).
template <bool ADJ>
__device__ __forceinline__ int io_at(int T, int s) {
  return ADJ ? T - 1 - s : s;
}

// G steps of the recurrence on a register ring (p == P): before step q the
// state component i (the output i + 1 steps back) is buf[(q - 1 - i) mod P]
// and step q overwrites buf[q], the oldest. The older taps (i >= 1) go into
// four independent sums, so a step's dependent chain is about a quarter of
// p long, and only the last FMA (tap 0, the newest output) waits on the
// step before. rows holds tap i of step q at [q][i]; the input is added
// where add_x; sy, where given, takes the outputs.
template <int P, bool FULL>
__device__ __forceinline__ void ring_group(double (&buf)[P], int nvalid,
                                           const double* rows,
                                           const double* sx, bool add_x,
                                           float* sy) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (FULL || q < nvalid) {
      const double* c = rows + q * P;
      double acc[4] = {add_x ? sx[q] : 0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int i = P - 1; i >= 1; --i)
        acc[i & 3] = fma(-c[i], buf[(q - 1 - i + 2 * P) % P], acc[i & 3]);
      const double older = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      buf[q] = fma(-c[0], buf[(q - 1 + P) % P], older);
      if (sy != nullptr) sy[q] = (float)buf[q];
    }
  }
}

// nvalid steps on a state window in shared memory (one sum, oldest tap
// first): component i before step q is st[p + q - 1 - i]; afterwards the
// last p outputs move to st[0, p).
__device__ __forceinline__ void window_group(double* st, int p, int nvalid,
                                             const double* rows,
                                             const double* sx, bool add_x,
                                             float* sy) {
  for (int q = 0; q < nvalid; ++q) {
    double acc = add_x ? sx[q] : 0.0;
    const double* h = st + p + q - 1;
    for (int i = p - 1; i >= 0; --i) acc = fma(-rows[q * p + i], h[-i], acc);
    st[p + q] = acc;
    if (sy != nullptr) sy[q] = (float)acc;
  }
  for (int k = 0; k < p; ++k) st[k] = st[nvalid + k];
}

// ---------------------------------------------------------------------------
// Phases 1 (MAPS) and 3. Grid (chunks, B): phase 1 the chunks but the last
// of every sequence, p + 1 threads rounded up to warps; phase 3 every
// chunk, one warp whose lanes all run the same recurrence (lane 0 writes).
// A group's taps are staged in step order, tap i of step q at [q][i], as
// float64: coalesced rows for the forward; for the adjoint gathered along
// the diagonal, row T - s0 - q + i (zero at or past T).
// ---------------------------------------------------------------------------

template <int P, bool MAPS>
size_t chunk_smem(int p, int nt) {
  const int G = group_steps(P);
  size_t doubles = (size_t)G * p + G;
  if (MAPS) doubles += (size_t)(p + 1) * p;
  if (P == 0) doubles += (size_t)nt * odd(p + G);
  return doubles * sizeof(double) + ((size_t)G * p + 2 * G) * sizeof(float);
}

// Issues the copies of group g0's taps and inputs, as fp32, into stage
// (taps [G][p], then G inputs); a copy of 0 bytes zero-fills.
template <int G, bool ADJ>
__device__ __forceinline__ void issue_group(const float* xb, const float* ab,
                                            float* stage, int T, int pp,
                                            int s0, int nv, int tid,
                                            int nt) {
  if (!ADJ) {
    const float* src = ab + (size_t)s0 * pp;
    const int valid = nv * pp;
    for (int e = tid; e < G * pp; e += nt)
      __pipeline_memcpy_async(stage + e, e < valid ? src + e : ab, 4,
                              e < valid ? 0 : 4);
  } else {
    int q = tid / pp, i = tid % pp;
    const int dq = nt / pp, di = nt % pp;
    for (int e = tid; e < G * pp; e += nt) {
      const int row = T - s0 - q + i;
      const bool ok = q < nv && row < T;
      __pipeline_memcpy_async(stage + e, ok ? ab + (size_t)row * pp + i : ab,
                              4, ok ? 0 : 4);
      q += dq;
      i += di;
      if (i >= pp) {
        i -= pp;
        ++q;
      }
    }
  }
  for (int q = tid; q < G; q += nt)
    __pipeline_memcpy_async(stage + G * pp + q,
                            q < nv ? xb + io_at<ADJ>(T, s0 + q) : xb, 4,
                            q < nv ? 0 : 4);
  __pipeline_commit();
}

template <int P, bool ADJ, bool MAPS>
__global__ void __launch_bounds__(P > 0 ? 32 : 96, P > 0 ? 16 : 1)
chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
             float* __restrict__ y, double* __restrict__ maps,
             const double* __restrict__ s_in, int T, int p, int L, int K) {
  constexpr int G = group_steps(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pp = P > 0 ? P : p;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  double* rows = reinterpret_cast<double*>(smem_raw);  // [G][p] taps
  double* sx = rows + G * pp;                          // [G] inputs
  double* col = sx + G;                                // [p + 1][p] (MAPS)
  double* win = col + (MAPS ? (pp + 1) * pp : 0);      // windows (P == 0)
  double* st = win + tid * odd(pp + G);
  float* stage = reinterpret_cast<float*>(
      win + (P == 0 ? nt * odd(pp + G) : 0));          // next group, fp32
  float* sy = stage + G * pp + G;                      // [G] outputs
  const float* xb = x + (size_t)b * T;
  const float* ab = a + (size_t)b * T * pp;
  const int s_begin = k * L;
  const int n = min(L, T - s_begin);
  const bool add_x = MAPS ? tid == pp : true;
  float* out = (!MAPS && tid == 0) ? sy : nullptr;
  const bool runs = MAPS ? tid <= pp : true;

  issue_group<G, ADJ>(xb, ab, stage, T, pp, s_begin, min(G, n), tid, nt);
  double buf[P > 0 ? P : 1];
  if (MAPS) {
    if constexpr (P > 0) {
#pragma unroll
      for (int q = 0; q < P; ++q) buf[q] = (P - 1 - q == tid) ? 1.0 : 0.0;
    } else if (runs) {
      for (int i = 0; i < pp; ++i) st[pp - 1 - i] = (i == tid) ? 1.0 : 0.0;
    }
  } else {
    const double* sk = s_in + ((size_t)b * K + k) * pp;
    if constexpr (P > 0) {
#pragma unroll
      for (int q = 0; q < P; ++q) buf[q] = sk[P - 1 - q];
    } else {
      for (int i = 0; i < pp; ++i) st[pp - 1 - i] = sk[i];
    }
  }

  // each group: its fp32 copies land and become float64 rows, the next
  // group's copies go out, then the recurrence runs over the rows
  for (int g0 = 0; g0 < n; g0 += G) {
    const int s0 = s_begin + g0;
    const int nv = min(G, n - g0);
    __pipeline_wait_prior(0);
    __syncthreads();                      // copies landed; last group done
    if (!MAPS && g0 > 0) {                // the previous group's outputs
      for (int q = tid; q < G; q += nt)
        y[(size_t)b * T + io_at<ADJ>(T, s0 - G + q)] = sy[q];
    }
    for (int e = tid; e < G * pp; e += nt) rows[e] = stage[e];
    for (int q = tid; q < G; q += nt) sx[q] = stage[G * pp + q];
    __syncthreads();                      // rows set; stage free
    if (g0 + G < n)
      issue_group<G, ADJ>(xb, ab, stage, T, pp, s0 + G, min(G, n - g0 - G),
                          tid, nt);
    if constexpr (P > 0) {
      if (nv == G)
        ring_group<P, true>(buf, nv, rows, sx, add_x, out);
      else
        ring_group<P, false>(buf, nv, rows, sx, add_x, out);
    } else if (runs) {
      window_group(st, pp, nv, rows, sx, add_x, out);
    }
  }
  __syncthreads();

  if (!MAPS) {
    const int g_last = (n - 1) / G * G;
    for (int q = tid; q < n - g_last; q += nt)
      y[(size_t)b * T + io_at<ADJ>(T, s_begin + g_last + q)] = sy[q];
    return;
  }
  // thread c writes column c (c = p: the offset v) of the end state
  if (runs) {
    if constexpr (P > 0) {
      const int last = (n - 1) % P;
#pragma unroll
      for (int q = 0; q < P; ++q) col[tid * pp + (last - q + P) % P] = buf[q];
    } else {
      for (int i = 0; i < pp; ++i) col[tid * pp + i] = st[pp - 1 - i];
    }
  }
  __syncthreads();
  double* dst = maps + ((size_t)b * (K - 1) + k) * (pp + 1) * pp;
  for (int e = tid; e < (pp + 1) * pp; e += nt) dst[e] = col[e];
}

// ---------------------------------------------------------------------------
// Phase 2: the carry. One CTA per sequence, thread i < p computes row i:
// s_{k+1}[i] = v_k[i] + sum_j M_k[i][j] s_k[j], with M_k stored by column
// (entry (i, j) at j p + i, so thread i reads consecutive addresses).
// s_0 is the initial state zi (B, p), turned to float64, or zero where zi
// is null; with one chunk (K = 1) there are no maps and the re-run starts
// from it.
// P bounds p (the sum is unrolled over P).
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(32 * ((P + 31) / 32))
carry_kernel(const double* __restrict__ maps, const float* __restrict__ zi,
             double* __restrict__ s_in, int p, int K) {
  constexpr int stages = carry_stages(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_map = (p + 1) * p;        // even: 16-byte copies tile it
  double* ring = reinterpret_cast<double*>(smem_raw);
  double* ss = ring + (size_t)stages * per_map;
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const int nmaps = K - 1;
  const double* mb = maps + (size_t)b * nmaps * per_map;
  double* sb = s_in + (size_t)b * K * p;

  auto issue = [&](int k) {
    if (k < nmaps) {
      const double* src = mb + (size_t)k * per_map;
      double* dst = ring + (size_t)(k % stages) * per_map;
      for (int e = 2 * i; e < per_map; e += 2 * nt)
        __pipeline_memcpy_async(dst + e, src + e, 16);
    }
    __pipeline_commit();  // an empty group keeps the wait count uniform
  };

  if (i < p) {
    // zi[b, i] is the output i + 1 steps before the first, which is state
    // component i, the slot the re-run reads as y[t - 1 - i]
    const double z = zi != nullptr ? (double)zi[(size_t)b * p + i] : 0.0;
    ss[i] = z;
    sb[i] = z;
  }
  for (int k = 0; k < stages - 1; ++k) issue(k);
  for (int k = 0; k < nmaps; ++k) {
    issue(k + stages - 1);
    __pipeline_wait_prior(stages - 1);    // map k has landed (own copies)
    __syncthreads();                      // ... and everyone's; ss is set
    const double* m = ring + (size_t)(k % stages) * per_map;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    if (i < p) {
      acc[0] = m[p * p + i];
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < p) acc[j & 3] = fma(m[j * p + i], ss[j], acc[j & 3]);
    }
    __syncthreads();                      // ss and ring slot k % stages read
    if (i < p) {
      const double s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      ss[i] = s;
      sb[(size_t)(k + 1) * p + i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The summary's composition. One CTA per sequence keeps the product
// W = [M | v] (p x (p + 1), by column, as the maps are stored) of the K
// chunk maps, W <- M_k W + [0 | v_k], instead of applying it to a state:
// thread e computes entries e, e + nt, ... of the next product from the
// map in shared memory. It writes M (B, p, p), row-major, entry (i, j) the
// end state's component i for a unit incoming component j, and v (B, p),
// the end state from a zero incoming state, both float64.
// ---------------------------------------------------------------------------

__global__ void compose_kernel(const double* __restrict__ maps,
                               double* __restrict__ m_out,
                               double* __restrict__ v_out, int p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per_map = (p + 1) * p;
  double* w = reinterpret_cast<double*>(smem_raw);     // [p + 1][p]
  double* wn = w + per_map;                            // the next product
  double* mk = wn + per_map;                           // map k
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double* mb = maps + (size_t)b * K * per_map;
  for (int e = tid; e < per_map; e += nt) {
    const int c = e / p, i = e % p;
    w[e] = (c == i) ? 1.0 : 0.0;
  }
  for (int k = 0; k < K; ++k) {
    __syncthreads();                      // w set; mk free
    for (int e = tid; e < per_map; e += nt) mk[e] = mb[(size_t)k * per_map + e];
    __syncthreads();
    for (int e = tid; e < per_map; e += nt) {
      const int c = e / p, i = e % p;
      double acc = (c == p) ? mk[p * p + i] : 0.0;
      for (int j = 0; j < p; ++j) acc = fma(mk[j * p + i], w[c * p + j], acc);
      wn[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < per_map; e += nt) w[e] = wn[e];
  }
  __syncthreads();
  for (int e = tid; e < per_map; e += nt) {
    const int c = e / p, i = e % p;
    if (c < p)
      m_out[((size_t)b * p + i) * p + c] = w[e];
    else
      v_out[(size_t)b * p + i] = w[e];
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// P: the register ring's order, or 0 for the window in shared memory (then
// CP = 64 bounds the carry's order)
template <int P, bool ADJ>
cudaError_t run(const float* x, const float* a, const float* zi, float* y,
                double* scratch, int B, int T, int p, int L,
                cudaStream_t stream) {
  constexpr int CP = P > 0 ? P : 64;
  const int K = (T + L - 1) / L;
  double* maps = scratch;
  double* s_in = scratch + (size_t)B * (K - 1) * (p + 1) * p;
  cudaError_t err;

  if (K > 1) {
    const int nt = 32 * ((p + 1 + 31) / 32);
    const size_t smem = chunk_smem<P, true>(p, nt);
    auto* k1 = chunk_kernel<P, ADJ, true>;
    if ((err = allow_smem((const void*)k1, smem)) != cudaSuccess) return err;
    k1<<<dim3(K - 1, B), nt, smem, stream>>>(x, a, nullptr, maps, nullptr, T,
                                              p, L, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t smem2 =
      (carry_stages(CP) * (size_t)(p + 1) * p + CP) * sizeof(double);
  auto* k2 = carry_kernel<CP>;
  if ((err = allow_smem((const void*)k2, smem2)) != cudaSuccess) return err;
  k2<<<B, 32 * ((p + 31) / 32), smem2, stream>>>(maps, zi, s_in, p, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = chunk_smem<P, false>(p, 32);
  auto* k3 = chunk_kernel<P, ADJ, false>;
  if ((err = allow_smem((const void*)k3, smem3)) != cudaSuccess) return err;
  k3<<<dim3(K, B), 32, smem3, stream>>>(x, a, y, nullptr, s_in, T, p, L, K);
  return cudaGetLastError();
}

// The summary: phase 1 over every chunk, the last included (the maps' stride
// is K, so the kernel is given K + 1 chunks and launched over K), then the
// composition.
template <int P>
cudaError_t run_summary(const float* x, const float* a, double* m_out,
                        double* v_out, double* scratch, int B, int T, int p,
                        int L, cudaStream_t stream) {
  const int K = (T + L - 1) / L;
  cudaError_t err;
  const int nt = 32 * ((p + 1 + 31) / 32);
  const size_t smem = chunk_smem<P, true>(p, nt);
  auto* k1 = chunk_kernel<P, false, true>;
  if ((err = allow_smem((const void*)k1, smem)) != cudaSuccess) return err;
  k1<<<dim3(K, B), nt, smem, stream>>>(x, a, nullptr, scratch, nullptr, T, p,
                                        L, K + 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem2 = 3 * (size_t)(p + 1) * p * sizeof(double);
  if ((err = allow_smem((const void*)compose_kernel, smem2)) != cudaSuccess)
    return err;
  const int warps = min(16, (p * (p + 1) + 31) / 32);
  compose_kernel<<<B, 32 * warps, smem2, stream>>>(scratch, m_out, v_out, p,
                                                   K);
  return cudaGetLastError();
}

template <bool ADJ>
int dispatch(const float* x, const float* a, const float* zi, float* y,
             double* scratch, int B, int T, int p, int L, int device,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p < 1 || p > 64 || L < 1 || T < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (p == kRingOrder)
    return (int)run<kRingOrder, ADJ>(x, a, zi, y, scratch, B, T, p, L,
                                     stream);
  return (int)run<0, ADJ>(x, a, zi, y, scratch, B, T, p, L, stream);
}

}  // namespace

// scratch: B (ceil(T / L) - 1) (p + 1) p doubles of maps, then
// B ceil(T / L) p doubles of incoming states. zi: the initial state (B, p),
// the last p outputs before x, most recent first; null for a zero state.
// The adjoint entry takes it too, so that both entries share one signature;
// its wrapper passes null (the cotangent's recurrence starts from zero past
// the end, where the coefficients it would need lie outside a).
extern "C" int golf_allpole_tv_earlier(const float* x, const float* a,
                               const float* zi, float* y, double* scratch,
                               int B, int T, int p, int L, int device,
                               cudaStream_t stream) {
  return dispatch<false>(x, a, zi, y, scratch, B, T, p, L, device, stream);
}

extern "C" int golf_allpole_tv_earlier_adjoint(const float* g, const float* a,
                                       const float* zi, float* dx,
                                       double* scratch, int B, int T, int p,
                                       int L, int device,
                                       cudaStream_t stream) {
  return dispatch<true>(g, a, zi, dx, scratch, B, T, p, L, device, stream);
}

// The affine end-state summary of each sequence (B, T): s_out = M s_in + v,
// the state after the last step as a function of the state before the
// first, in float64. m_out (B, p, p), v_out (B, p); scratch: B ceil(T / L)
// (p + 1) p doubles of chunk maps. Replaces the XLA computation of
// golf_tpu/parallel/seqpar.py::_local_affine_summary, which the time-sharded
// all-pole filter runs once per shard in its forward and in its backward.
extern "C" int golf_allpole_tv_earlier_summary(const float* x, const float* a,
                                       double* m_out, double* v_out,
                                       double* scratch, int B, int T, int p,
                                       int L, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p < 1 || p > 64 || L < 1 || T < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (p == kRingOrder)
    return (int)run_summary<kRingOrder>(x, a, m_out, v_out, scratch, B, T, p,
                                        L, stream);
  return (int)run_summary<0>(x, a, m_out, v_out, scratch, B, T, p, L, stream);
}
