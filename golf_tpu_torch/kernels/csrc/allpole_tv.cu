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
// materialised operands bit for bit.
//
// The time-sharded filter (parallel/seqpar.py) runs a shard's (x, a) twice
// a direction: golf_allpole_tv_summary returns the shard's affine end-state
// map in float64 (the boundary exchange; no Pallas kernel: golf_tpu's
// seqpar._local_affine_summary is XLA) and keeps every chunk's map in the
// caller's buffer, then golf_allpole_tv_rerun runs the forward entry's
// phases 2 and 3 from those maps and the incoming state, so phase 1 runs
// once a direction. The re-run equals golf_allpole_tv with zi bit for bit.
//
// Design: the chunked two-pass form, three kernels on the caller's stream.
// Steps (time, or reversed time) are cut into chunks of L (from the caller,
// ops/allpole.py's chunk_for: short chunks where few rows would leave the
// card's 132 SMs idle, 512 at the training and serving shapes).
//  1. maps: one CTA per (sequence, chunk but the last; the summary every
//     chunk). Thread c < p tracks column c of the chunk's state map (the
//     state's response to incoming state component c), thread p its
//     zero-state response; all read the same coefficients from shared
//     memory (a broadcast). Only the end map M_k (p x p, stored by column)
//     and offset v_k (p) are written, in float64.
//  2. carry: one warp per sequence runs s_{k+1} = M_k s_k + v_k in float64
//     over the chunks, lane i row i, the state in registers (shuffles), the
//     next maps in flight as bulk copies; it writes every chunk's incoming
//     state.
//  3. re-run: every chunk runs the recurrence again from its incoming
//     state and writes y, one warp a chunk, all lanes running the same
//     recurrence; at p = 22, where the caller asks (ops/allpole.py's
//     rerun_chunks: chunks enough that the paired grid fills the card), a
//     warp takes two chunks, 16 lanes each (a warp instruction costs the
//     same for one lane as for 32). It is float64 too: in a trial of the
//     plain mirror on the CPU, a float32 re-run from the float64 state
//     exceeded the float32 scan's error on two of six uncapped resonant
//     filters.
// Phases 1 and 3 share their staging. A group of steps' taps and inputs are
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
//    sequence, ~0.4 us each on the H100 (the float64 chain's latency: more
//    maps in flight do not shorten it).
// The summary adds the composition of ceil(T / L) maps a sequence, a tree
// (log2 of the chunks deep) of p (p + 1) p FMA products on the float64
// tensor cores (p <= 23), its copies in flight together; its work is p / L
// of phase 1's.

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
// Phases 1 (MAPS) and 3. Grid (chunks, B): phase 1 the chunks it maps (the
// forward entry all but the last of every sequence, the summary all), p + 1
// threads rounded up to warps, map k of sequence b at b K + k; phase 3 every
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

// CTAs of phases 1 and 3 an SM at p = 22 (the registers a thread may take:
// 65536 / (32 x this)). On the H100 12 ran the adjoint entry at training
// and the summary faster than 16 (the forward, the zi entry and a push
// alike; PERF.md)
constexpr int kMinCtas = 12;

template <int P, bool ADJ, bool MAPS>
__global__ void __launch_bounds__(P > 0 ? 32 : 96, P > 0 ? kMinCtas : 1)
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
  double* dst = maps + ((size_t)b * K + k) * (pp + 1) * pp;
  for (int e = tid; e < (pp + 1) * pp; e += nt) dst[e] = col[e];
}

// ---------------------------------------------------------------------------
// Phase 3 at p = 22, NC chunks a CTA (rerun_kernel). The kernel above runs
// a chunk's re-run on one warp whose 32 lanes all run the same recurrence;
// here the warp's lanes form NC groups of 32 / NC, group g running chunk
// NC blockIdx.x + g from its own staged rows (the groups' rows sit in
// distinct banks), so one instruction stream serves NC chunks. All lanes
// copy and convert every chunk's group of taps, and write every chunk's
// outputs (lane 0 of a group stages them). Each chunk's arithmetic is the
// kernel above's, so the outputs are the same bit for bit.
// ---------------------------------------------------------------------------

// The chunks a CTA, NC, come from the caller (ops/allpole.py's
// rerun_chunks: 2 where the paired grid still fills the card, else 1, the
// kernel above); only NC = 2 is built, since four or eight chunks a CTA
// ran slower than two on the H100 (PERF.md).
constexpr int kRerunPair = 2;

template <int NC>
size_t rerun_smem() {
  constexpr int G = kRingOrder, P = kRingOrder;
  return NC * ((size_t)(G * P + G) * sizeof(double) +
               (size_t)(G * P + 2 * G) * sizeof(float));
}

template <bool ADJ, int NC>
__global__ void __launch_bounds__(32, kMinCtas)
rerun_kernel(const float* __restrict__ x, const float* __restrict__ a,
             float* __restrict__ y, const double* __restrict__ s_in, int T,
             int L, int K) {
  constexpr int P = kRingOrder;
  constexpr int G = P;
  constexpr int LG = 32 / NC;                 // lanes a chunk
  constexpr int DBL = G * P + G;              // doubles a chunk: rows, sx
  constexpr int FLT = G * P + 2 * G;          // floats a chunk: stage, sy
  static_assert(32 % NC == 0, "NC divides a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* dbl = reinterpret_cast<double*>(smem_raw);
  float* flt = reinterpret_cast<float*>(dbl + NC * DBL);
  const int tid = threadIdx.x;
  const int grp = tid / LG;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * NC;            // the CTA's first chunk
  const float* xb = x + (size_t)b * T;
  const float* ab = a + (size_t)b * T * P;
  auto steps = [&](int j) {                   // chunk k0 + j's steps
    return k0 + j < K ? min(L, T - (k0 + j) * L) : 0;
  };
  auto valid = [&](int j, int g0) { return max(0, min(G, steps(j) - g0)); };
  const int n_max = steps(0);                 // later chunks are no longer

  auto issue = [&](int g0) {
    for (int j = 0; j < NC; ++j)
      issue_group<G, ADJ>(xb, ab, flt + j * FLT, T, P, (k0 + j) * L + g0,
                          valid(j, g0), tid, 32);
  };
  auto write = [&](int g0) {                  // group g0's outputs
    for (int j = 0; j < NC; ++j) {
      const float* sy = flt + j * FLT + G * P + G;
      const int s0 = (k0 + j) * L + g0;
      for (int q = tid; q < valid(j, g0); q += 32)
        y[(size_t)b * T + io_at<ADJ>(T, s0 + q)] = sy[q];
    }
  };

  double buf[P];
  {
    const int k = k0 + grp;
    const double* sk = s_in + ((size_t)b * K + min(k, K - 1)) * P;
#pragma unroll
    for (int q = 0; q < P; ++q) buf[q] = k < K ? sk[P - 1 - q] : 0.0;
  }
  double* rows = dbl + grp * DBL;
  double* sx = rows + G * P;
  float* out = tid % LG == 0 ? flt + grp * FLT + G * P + G : nullptr;

  issue(0);
  int g0 = 0;
  for (; g0 < n_max; g0 += G) {
    __pipeline_wait_prior(0);
    __syncthreads();                          // copies landed; group done
    if (g0 > 0) write(g0 - G);
    for (int j = 0; j < NC; ++j) {
      const float* stage = flt + j * FLT;
      double* r = dbl + j * DBL;
      for (int e = tid; e < G * P + G; e += 32) r[e] = stage[e];
    }
    __syncthreads();                          // rows set; stages free
    if (g0 + G < n_max) issue(g0 + G);
    const int nv = valid(grp, g0);
    if (nv == G)
      ring_group<P, true>(buf, nv, rows, sx, true, out);
    else if (nv > 0)
      ring_group<P, false>(buf, nv, rows, sx, true, out);
  }
  __syncthreads();
  write(g0 - G);
}

// ---------------------------------------------------------------------------
// Phase 2: the carry, s_{k+1} = M_k s_k + v_k in float64 over a sequence's
// maps, M_k stored by column (entry (i, j) at j p + i). s_0 is the initial
// state zi (B, p), turned to float64, or zero where zi is null; with one
// chunk (K = 1) there are no maps and the re-run starts from it. The maps
// of sequence b start at map b K (only the first K - 1 are read). It writes
// every chunk's incoming state. Its chain is serial: ceil(T / L) - 1 steps
// of one p x p matrix-vector product, so a step's latency is what counts.
//
// p <= 32 (carry_warp_kernel): one warp a sequence, lane i keeps s[i] in a
// register and takes s[j] from lane j by shuffle, with no shared-memory
// round trip or block barrier in the chain; the maps arrive by bulk copies
// (cp.async.bulk, one instruction a map, completing on an mbarrier), a
// ring of kCarryStages maps in flight. p > 32 (carry_kernel): thread i
// row i, the state in shared memory, the maps prefetched by 16-byte
// cp.async. Both sum in the same order (four partial sums, j ascending).
// P bounds p (the sum is unrolled over P).
// ---------------------------------------------------------------------------

// maps in flight in the carry (p <= 32); on the H100 32 ran no faster
// than 8 (PERF.md)
constexpr int kCarryStages = 8;

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <int P>
__global__ void __launch_bounds__(32)
carry_warp_kernel(const double* __restrict__ maps,
                  const float* __restrict__ zi, double* __restrict__ s_in,
                  int p, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long full[kCarryStages];
  const int per_map = (p + 1) * p;
  const unsigned bytes = per_map * sizeof(double);   // p (p + 1) even: x16
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nmaps = K - 1;
  const double* mb = maps + (size_t)b * K * per_map;
  double* sb = s_in + (size_t)b * K * p;
  if (lane == 0) {
    for (int st = 0; st < kCarryStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + st))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // lane 0 sends map k into slot k % kCarryStages
  auto issue = [&](int k) {
    if (lane == 0 && k < nmaps) {
      const int st = k % kCarryStages;
      const unsigned bar = smem_u32(full + st);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + (size_t)st *
                                                       per_map)),
          "l"(mb + (size_t)k * per_map), "r"(bytes), "r"(bar)
          : "memory");
    }
  };
  for (int k = 0; k < kCarryStages; ++k) issue(k);

  // zi[b, i] is the output i + 1 steps before the first, which is state
  // component i, the slot the re-run reads as y[t - 1 - i]
  double s = (lane < p && zi != nullptr) ? (double)zi[(size_t)b * p + lane]
                                         : 0.0;
  if (lane < p) sb[lane] = s;
  for (int k = 0; k < nmaps; ++k) {
    const int st = k % kCarryStages;
    mbar_wait(smem_u32(full + st), (k / kCarryStages) & 1);
    const double* m = ring + (size_t)st * per_map;
    double acc[4] = {lane < p ? m[p * p + lane] : 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const double sj = __shfl_sync(0xffffffffu, s, j);
      if (j < p && lane < p) acc[j & 3] = fma(m[j * p + lane], sj, acc[j & 3]);
    }
    // every lane's reads of the slot are done before it is refilled
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    issue(k + kCarryStages);
    s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    if (lane < p) sb[(size_t)(k + 1) * p + lane] = s;
  }
}

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
  const double* mb = maps + (size_t)b * K * per_map;
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
// The summary's composition, a tree. The product of maps k0 .. k1 - 1 (k0
// first in time) is M_{k1 - 1} ... M_{k0}; a level of the tree multiplies
// each pair of neighbours (2j + 1 after 2j) and passes an odd last map on,
// so n maps take ceil(log2 n) levels, each one multiply deep. Grid
// (groups, B), 256 threads: CTA g copies maps g NB .. g NB + NB - 1 of its
// sequence into shared memory, every copy in flight at once (cp.async), and
// composes them a level at a time, a product a warp on the tensor cores
// (p <= 23) or over all its threads (other orders); with more than
// one group it writes its product, and the last CTA of the sequence to
// finish (a per-sequence counter, raised after a __threadfence) composes
// the group products in the same way, NB at a time, the product so far
// first in each round after the first. NB comes from the caller
// (ops/allpole.py's tree_group) and is 16 for p = 22,
// so up to 256 chunks take one round. It writes M (B, p, p), row-major,
// entry (i, j) the end state's component i for a unit incoming component
// j, and v (B, p), the end state from a zero incoming state, in float64.
// ---------------------------------------------------------------------------

constexpr int kTreeThreads = 256;

// The n maps at src composed as a tree, over all the CTA's threads, with
// other (ceil(n / 2) slots) as the second buffer of the levels; returns
// where the product lies. src must be visible to every thread on entry.
// A product later o earlier (both stored by column) has column c < p =
// later's M times earlier's column c and column p = that plus later's
// offset; a thread takes row i of kTreeCols columns at once, independent
// sums over k that share later's entry (i, k).
constexpr int kTreeCols = 8;

__device__ double* tree(double* src, double* other, int n, int p, int per) {
  constexpr int C = kTreeCols;
  const int items = p * ((p + C) / C);       // (row, block of C columns)
  while (n > 1) {
    const int m = (n + 1) / 2;
    for (int w = threadIdx.x; w < m * items; w += blockDim.x) {
      const int j = w / items, r = w - j * items;
      const int i = r % p, c0 = r / p * C;
      const int nc = min(C, p + 1 - c0);
      double* out = other + (size_t)j * per;
      const double* lo = src + (size_t)2 * j * per;
      if (2 * j + 1 < n) {
        const double* hi = lo + per;
        double acc[C];
#pragma unroll
        for (int t = 0; t < C; ++t) acc[t] = c0 + t == p ? hi[p * p + i] : 0.0;
        for (int k = 0; k < p; ++k) {
          const double l = hi[k * p + i];
#pragma unroll
          for (int t = 0; t < C; ++t)
            if (t < nc) acc[t] = fma(l, lo[(c0 + t) * p + k], acc[t]);
        }
#pragma unroll
        for (int t = 0; t < C; ++t)
          if (t < nc) out[(c0 + t) * p + i] = acc[t];
      } else {
#pragma unroll
        for (int t = 0; t < C; ++t)
          if (t < nc) out[(c0 + t) * p + i] = lo[(c0 + t) * p + i];
      }
    }
    __syncthreads();
    double* t = src;
    src = other;
    other = t;
    n = m;
  }
  return src;
}

// The same tree on the float64 tensor cores, for p <= 23 (a map pads to
// 24 x 24): a warp a product, 3 x 3 output tiles of 8 x 8, each the sum of
// six mma.m8n8k4 steps over k (rows and columns past p read as zero), and
// the offset column adds later's offset. mma.m8n8k4.f64 fragments: A (8 x 4,
// row-major) one value a lane at (lane / 4, lane % 4), B (4 x 8, by column)
// at (lane % 4, lane / 4), C and D two at (lane / 4, 2 (lane % 4) + u).
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void compose_mma(const double* hi,
                                            const double* lo, double* out,
                                            int p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double acc[3][3][2];
#pragma unroll
  for (int ti = 0; ti < 3; ++ti)
#pragma unroll
    for (int tc = 0; tc < 3; ++tc) acc[ti][tc][0] = acc[ti][tc][1] = 0.0;
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const int k = kk * 4 + t;
    double af[3], bf[3];
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
      const int i = ti * 8 + g;
      af[ti] = i < p && k < p ? hi[k * p + i] : 0.0;
    }
#pragma unroll
    for (int tc = 0; tc < 3; ++tc) {
      const int c = tc * 8 + g;
      bf[tc] = c <= p && k < p ? lo[c * p + k] : 0.0;
    }
#pragma unroll
    for (int ti = 0; ti < 3; ++ti)
#pragma unroll
      for (int tc = 0; tc < 3; ++tc) dmma(acc[ti][tc], af[ti], bf[tc]);
  }
#pragma unroll
  for (int ti = 0; ti < 3; ++ti)
#pragma unroll
    for (int tc = 0; tc < 3; ++tc)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = ti * 8 + g, c = tc * 8 + 2 * t + u;
        if (i < p && c <= p)
          out[c * p + i] = c == p ? acc[ti][tc][u] + hi[p * p + i]
                                  : acc[ti][tc][u];
      }
}

__device__ double* tree_mma(double* src, double* other, int n, int p,
                            int per) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  while (n > 1) {
    const int m = (n + 1) / 2;
    for (int j = warp; j < m; j += nw) {
      const double* lo = src + (size_t)2 * j * per;
      if (2 * j + 1 < n)
        compose_mma(lo + per, lo, other + (size_t)j * per, p);
      else
        for (int e = lane; e < per; e += 32) other[(size_t)j * per + e] = lo[e];
    }
    __syncthreads();
    double* t = src;
    src = other;
    other = t;
    n = m;
  }
  return src;
}

// a map's tree: on the tensor cores where it fits their 24 x 24 padding
__device__ double* tree_any(double* src, double* other, int n, int p,
                            int per) {
  return p <= 23 ? tree_mma(src, other, n, p, per)
                 : tree(src, other, n, p, per);
}

__global__ void __launch_bounds__(kTreeThreads)
compose_kernel(const double* __restrict__ maps, double* __restrict__ partial,
               unsigned* __restrict__ counter, double* __restrict__ m_out,
               double* __restrict__ v_out, int p, int K, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  const int per = (p + 1) * p;              // even: 16-byte copies tile it
  double* slots = reinterpret_cast<double*>(smem_raw);   // [nb] maps
  double* other = slots + (size_t)nb * per;              // [nb / 2]
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int ng = gridDim.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = min(nb, K - g * nb);
  const double* src = maps + ((size_t)b * K + (size_t)g * nb) * per;
  for (int e = 2 * tid; e < n * per; e += 2 * nt)
    __pipeline_memcpy_async(slots + e, src + e, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  double* w = tree_any(slots, other, n, p, per);

  if (ng > 1) {
    double* dst = partial + ((size_t)b * ng + g) * per;
    for (int e = tid; e < per; e += nt) dst[e] = w[e];
    __threadfence();                        // the product, then the count
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counter + b, 1u) == (unsigned)(ng - 1);
      if (last) counter[b] = 0;             // every CTA of b has counted
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // rounds of up to nb: the product so far (after the first round), then
    // the next group products, read from L2 (other CTAs wrote them)
    w = nullptr;
    for (int g0 = 0; g0 < ng;) {
      int lead = 0;
      if (w != nullptr) {
        if (w != slots)
          for (int e = tid; e < per; e += nt) slots[e] = w[e];
        lead = 1;
      }
      const int take = min(nb - lead, ng - g0);
      const double* pb = partial + ((size_t)b * ng + g0) * per;
      for (int e = tid; e < take * per; e += nt)
        slots[(size_t)lead * per + e] = __ldcg(pb + e);
      __syncthreads();
      w = tree_any(slots, other, lead + take, p, per);
      g0 += take;
    }
  }
  for (int e = tid; e < per; e += nt) {
    const int c = e / p, i = e - c * p;
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

// Phase 1 over the first n chunks of every sequence (maps at stride K).
template <int P, bool ADJ>
cudaError_t run_maps(const float* x, const float* a, double* maps, int B,
                     int T, int p, int L, int K, int n, cudaStream_t stream) {
  const int nt = 32 * ((p + 1 + 31) / 32);
  const size_t smem = chunk_smem<P, true>(p, nt);
  auto* k1 = chunk_kernel<P, ADJ, true>;
  cudaError_t err = allow_smem((const void*)k1, smem);
  if (err != cudaSuccess) return err;
  k1<<<dim3(n, B), nt, smem, stream>>>(x, a, nullptr, maps, nullptr, T, p, L,
                                        K);
  return cudaGetLastError();
}

// Phases 2 and 3 from the maps: the carry from zi, then every chunk
// re-run from its incoming state, nc chunks a CTA.
template <int P, bool ADJ>
cudaError_t run_carry(const float* x, const float* a, const float* zi,
                      const double* maps, float* y, double* s_in, int B,
                      int T, int p, int L, int K, int nc,
                      cudaStream_t stream) {
  cudaError_t err;
  if (p <= 32) {
    constexpr int CP = P > 0 ? P : 32;
    const size_t smem2 = kCarryStages * (size_t)(p + 1) * p * sizeof(double);
    auto* k2 = carry_warp_kernel<CP>;
    if ((err = allow_smem((const void*)k2, smem2)) != cudaSuccess) return err;
    k2<<<B, 32, smem2, stream>>>(maps, zi, s_in, p, K);
  } else {
    const size_t smem2 =
        (carry_stages(64) * (size_t)(p + 1) * p + 64) * sizeof(double);
    auto* k2 = carry_kernel<64>;
    if ((err = allow_smem((const void*)k2, smem2)) != cudaSuccess) return err;
    k2<<<B, 32 * ((p + 31) / 32), smem2, stream>>>(maps, zi, s_in, p, K);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if constexpr (P == kRingOrder) {
    if (nc == kRerunPair) {
      constexpr int NC = kRerunPair;
      auto* k3 = rerun_kernel<ADJ, NC>;
      if ((err = allow_smem((const void*)k3, rerun_smem<NC>())) !=
          cudaSuccess)
        return err;
      k3<<<dim3((K + NC - 1) / NC, B), 32, rerun_smem<NC>(), stream>>>(
          x, a, y, s_in, T, L, K);
      return cudaGetLastError();
    }
  }
  {
    const size_t smem3 = chunk_smem<P, false>(p, 32);
    auto* k3 = chunk_kernel<P, ADJ, false>;
    if ((err = allow_smem((const void*)k3, smem3)) != cudaSuccess) return err;
    k3<<<dim3(K, B), 32, smem3, stream>>>(x, a, y, nullptr, s_in, T, p, L,
                                          K);
  }
  return cudaGetLastError();
}

// P: the register ring's order, or 0 for the window in shared memory (then
// 64 bounds the carry's order)
template <int P, bool ADJ>
cudaError_t run(const float* x, const float* a, const float* zi, float* y,
                double* scratch, int B, int T, int p, int L, int nc,
                cudaStream_t stream) {
  const int K = (T + L - 1) / L;
  double* maps = scratch;
  double* s_in = scratch + (size_t)B * K * (p + 1) * p;
  if (K > 1) {
    cudaError_t err = run_maps<P, ADJ>(x, a, maps, B, T, p, L, K, K - 1,
                                       stream);
    if (err != cudaSuccess) return err;
  }
  return run_carry<P, ADJ>(x, a, zi, maps, y, s_in, B, T, p, L, K, nc,
                           stream);
}

// The summary: phase 1 over every chunk, the last included, into the
// caller's maps, then the tree, nb maps a CTA.
template <int P>
cudaError_t run_summary(const float* x, const float* a, double* m_out,
                        double* v_out, double* maps, double* scratch, int B,
                        int T, int p, int L, int nb, cudaStream_t stream) {
  const int K = (T + L - 1) / L;
  cudaError_t err = run_maps<P, false>(x, a, maps, B, T, p, L, K, K, stream);
  if (err != cudaSuccess) return err;
  const int ng = (K + nb - 1) / nb;
  const size_t per = (size_t)(p + 1) * p;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + B * ng * per);
  if (ng > 1 &&
      (err = cudaMemsetAsync(counter, 0, B * sizeof(unsigned), stream)) !=
          cudaSuccess)
    return err;
  const size_t smem = (size_t)(nb + nb / 2) * per * sizeof(double);
  if ((err = allow_smem((const void*)compose_kernel, smem)) != cudaSuccess)
    return err;
  compose_kernel<<<dim3(ng, B), kTreeThreads, smem, stream>>>(
      maps, scratch, counter, m_out, v_out, p, K, nb);
  return cudaGetLastError();
}

cudaError_t check_sizes(int device, int B, int T, int p, int L) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (p < 1 || p > 64 || L < 1 || T < 1 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// nc: 1, or kRerunPair at p = kRingOrder
cudaError_t check_pair(int p, int nc) {
  return nc == 1 || (nc == kRerunPair && p == kRingOrder)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <bool ADJ>
int dispatch(const float* x, const float* a, const float* zi, float* y,
             double* scratch, int B, int T, int p, int L, int nc, int device,
             cudaStream_t stream) {
  cudaError_t err = check_sizes(device, B, T, p, L);
  if (err == cudaSuccess) err = check_pair(p, nc);
  if (err != cudaSuccess) return (int)err;
  if (p == kRingOrder)
    return (int)run<kRingOrder, ADJ>(x, a, zi, y, scratch, B, T, p, L, nc,
                                     stream);
  return (int)run<0, ADJ>(x, a, zi, y, scratch, B, T, p, L, nc, stream);
}

}  // namespace

// scratch: B ceil(T / L) (p + 1) p doubles of maps (the last chunk's slot
// of each sequence unused), then B ceil(T / L) p doubles of incoming
// states. zi: the initial state (B, p), the last p outputs before x, most
// recent first; null for a zero state. nc: chunks a CTA of phase 3, 1 or
// (at p = 22) 2 (ops/allpole.py's rerun_chunks).
// The adjoint entry takes it too, so that both entries share one signature;
// its wrapper passes null (the cotangent's recurrence starts from zero past
// the end, where the coefficients it would need lie outside a).
extern "C" int golf_allpole_tv(const float* x, const float* a,
                               const float* zi, float* y, double* scratch,
                               int B, int T, int p, int L, int nc,
                               int device, cudaStream_t stream) {
  return dispatch<false>(x, a, zi, y, scratch, B, T, p, L, nc, device,
                         stream);
}

extern "C" int golf_allpole_tv_adjoint(const float* g, const float* a,
                                       const float* zi, float* dx,
                                       double* scratch, int B, int T, int p,
                                       int L, int nc, int device,
                                       cudaStream_t stream) {
  return dispatch<true>(g, a, zi, dx, scratch, B, T, p, L, nc, device,
                        stream);
}

// The affine end-state summary of each sequence (B, T): s_out = M s_in + v,
// the state after the last step as a function of the state before the
// first, in float64. m_out (B, p, p), v_out (B, p); maps: B ceil(T / L)
// (p + 1) p doubles, every chunk's map, which the caller keeps for
// golf_allpole_tv_rerun; nb: the maps a CTA of the tree composes, at least
// 2, (nb + nb / 2) (p + 1) p doubles of shared memory (ops/allpole.py's
// tree_group); scratch: B ceil(ceil(T / L) / nb) (p + 1) p doubles of group
// products, then B unsigned counters.
// Replaces the XLA computation of
// golf_tpu/parallel/seqpar.py::_local_affine_summary, which the time-sharded
// all-pole filter runs once per shard in its forward and in its backward.
extern "C" int golf_allpole_tv_summary(const float* x, const float* a,
                                       double* m_out, double* v_out,
                                       double* maps, double* scratch, int B,
                                       int T, int p, int L, int nb,
                                       int device, cudaStream_t stream) {
  cudaError_t err = check_sizes(device, B, T, p, L);
  if (err != cudaSuccess) return (int)err;
  if (nb < 2) return (int)cudaErrorInvalidValue;
  if (p == kRingOrder)
    return (int)run_summary<kRingOrder>(x, a, m_out, v_out, maps, scratch, B,
                                        T, p, L, nb, stream);
  return (int)run_summary<0>(x, a, m_out, v_out, maps, scratch, B, T, p, L,
                             nb, stream);
}

// The forward entry from the summary's maps of the same (x, a) at the same
// L: the carry from zi and the re-run only (phases 2 and 3), so that a time
// shard runs phase 1 once a direction. It equals golf_allpole_tv with zi
// bit for bit at the same nc: its maps are the same kernel's on the same
// chunks. s_in: B ceil(T / L) p doubles.
extern "C" int golf_allpole_tv_rerun(const float* x, const float* a,
                                     const float* zi, const double* maps,
                                     float* y, double* s_in, int B, int T,
                                     int p, int L, int nc, int device,
                                     cudaStream_t stream) {
  cudaError_t err = check_sizes(device, B, T, p, L);
  if (err == cudaSuccess) err = check_pair(p, nc);
  if (err != cudaSuccess) return (int)err;
  const int K = (T + L - 1) / L;
  if (p == kRingOrder)
    return (int)run_carry<kRingOrder, false>(x, a, zi, maps, y, s_in, B, T, p,
                                             L, K, nc, stream);
  return (int)run_carry<0, false>(x, a, zi, maps, y, s_in, B, T, p, L, K, nc,
                                  stream);
}
