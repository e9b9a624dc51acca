// The SSD (Mamba-2) scan, for Hopper (sm_90a): a decode path and the
// chunk-parallel state-passing decomposition of the chunked scan.
//
// Replaces the TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (`_kernel`, pallas_call in `ssd_scan`), and serves what the JAX model
// computes in jnp (`Zamba2LM._ssd_scan`, src/repro/models/mamba2.py), which
// every Mamba2 layer of the recurrent and hybrid families runs on every
// serving step.  Contract: x (B, S, H, P) already scaled by dt; dA (B, S, H)
// float32 log decays; Bm, Cm (B, S, G, N) with H % G == 0 (head h reads
// group h / (H / G)); an optional float32 initial state (B, H, N, P); the
// float32 final state (B, H, N, P) is written out.  y (B, S, H, P) has x's
// dtype.  With G = H and no initial state, y is the TPU kernel's output (it
// returns no state).  All arithmetic is float32, on the CUDA cores.
//
// What it computes, per chunk of kQ steps, with cs the running sum of dA
// inside the chunk and h_prev the state before it:
//   Y      = ((C B^T) o exp(cs_i - cs_j) o [j <= i]) x  +  (C h_prev) o exp(cs)
//   h_next = exp(cs_last) h_prev + B^T (exp(cs_last - cs) o x)
// Any chunk length gives the same function up to rounding, so the kernel
// picks its own (kQ = 64) whatever chunk the model uses.  Steps past S in the
// last chunk read as dA = 0 and zero inputs: exact identities on h.  The
// segment cs_i - cs_j is exponentiated only where j <= i.
//
// What bounds it.  At decode (S = 1) the state: (B, H, N, P) float32 read
// and written once, 2 x 1.31 MB a lane and layer at zamba2 widths (N = P =
// 64), against 4 N P operations a head.  Over long chunks the operations:
// the function needs about 4 N P a step and head (the state update and
// C h), 67 TFLOP/s in float32 on the CUDA cores.
//
// Design.  Two paths behind one entry point, chosen by S:
// - Decode (S <= kDecodeMaxS, one kernel): the recurrence h <- exp(dA) h +
//   B x^T, y = C h, step by step with the state in registers.  A CTA of 128
//   threads owns (lane, head, 4 column units of P), a unit being a float4
//   (P % 4 == 0 and 16-byte-aligned states) or one float; 32 row groups of
//   threads hold N / 32 state rows each, loaded and stored as 16-byte
//   vectors.  B, C, x and the decays of every step are staged in shared
//   memory once; y's sum over N is a shuffle over the warp's 8 row groups
//   and a 4-warp sum.  B x H x P / 16 CTAs (320 at B = 1 for zamba2-2.7b).
// - Chunks (S > kDecodeMaxS, three kernels issued by one call):
//   (a) ssd_chunk_state, one CTA per (lane, chunk, head, 64 columns of P):
//       a warp scan of the chunk's dA (cs, stored for (b) and (c)) and the
//       chunk-local state B^T (exp(cs_last - cs) o x), N x 64 outputs in
//       register tiles of 4 columns; plus one CTA per (lane, chunk, group)
//       that forms C B^T once for every head of the group (G = 1 for
//       zamba2: one tile for 80 heads) and C^T, both to the workspace;
//   (b) ssd_state_pass, one thread per float4 of the state, walks the
//       chunks in order: stores h_prev over the chunk's local state in the
//       workspace and forms h_next; the loads of kPre chunks are issued
//       before their updates, so the pass runs at the bytes' pace;
//   (c) ssd_chunk_out, one CTA per (lane, chunk, head, 64 columns): stages
//       (C B^T o L) with the head's decays, x, C^T and h_prev, and forms
//       y = (C B^T o L) x + (C h_prev) o exp(cs) in 4 x 4 register tiles
//       (16 multiply-adds per two 16-byte shared-memory reads).
//   The workspace (chunk states, decays, C B^T, C^T) is allocated by the
//   wrapper; the chunk states cost 4 N P float32 bytes per chunk and head
//   of traffic, which kQ = 64 keeps at N / 16 times x's bytes.
// - Decays over a segment (exp(cs_i - cs_j), exp(cs_last - cs_j)) are
//   summed over the segment's own steps, never taken as a difference of
//   two running sums: at zamba2's decays those sums reach thousands within
//   a chunk, and a difference of two loses 1e-4 of the small segments that
//   carry the weight (a lane's padded tail, dA = 0, most of all).
// - Products on the CUDA cores in float32.  The tolerance is 2e-4 x
//   max|plain| in float32: TF32 keeps ~1e-3 and misses it.  3 x TF32 on
//   mma.sync m16n8k8 (hi/lo splits, three products, float32 sums) held it
//   in (c) but ran no faster than these FMAs at the main path's chunk
//   shapes (a throwaway build timed in turns on the card); a build of (c)
//   without its products kept more than half of (c)'s time, which goes to
//   staging (x and h_prev from HBM, C B^T and C^T from L2), the stores and
//   the CTAs' waves.  Kept on the CUDA cores.
//
// Tried and not kept: 8 x 4 register tiles over 128 threads (half the
// shared-memory reads a multiply-add): 96-247 registers, fewer CTAs per
// SM, (a) and (c) slower at zamba2's S = 1024 (phase 8's kernel split).
// A persistent (c), one CTA per SM prefetching its next item's tiles by
// cp.async into a second buffer while computing this one: 127 registers,
// one CTA per SM, slower than three independent CTAs at every main-path
// chunk shape (a throwaway build timed in turns on the card).
//
// What the first version did, and what this one removes: one CTA per (lane,
// head, 16 columns) walked every chunk of 32 steps in order (32 serial steps
// at S = 1024, every chunk's loads exposed), recomputed the 32 x 32 C B^T
// tile for each of the 80 heads and 4 column slices (about half its FMAs),
// summed the decays on one thread, and ran a decode step through the whole
// chunk machinery.
//
// The decode and chunk kernels carry no __launch_bounds__: with one, ptxas
// spilled the bf16 instantiations (12-28 bytes at 40-48 registers); without,
// none spills at 40-74 registers (phase 2 checks).
//
// N <= 128, G >= 1, any P; float32 and bfloat16 x, B, C, y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kQ = 64;                  // steps per chunk
constexpr int kPs = 64;                 // columns of P per chunk CTA
constexpr int kChunkThreads = 256;      // (a) and (c): 16 column blocks
constexpr int kRowBlocks = kChunkThreads / 16;  // x 16 row blocks
constexpr int kPassThreads = 128;       // (b): one float4 of state each
constexpr int kPre = 8;                 // chunks whose loads (b) overlaps
constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxS = 16;         // the decode path takes S <= this
constexpr int kDecodeCols = 4;          // column units per decode CTA
constexpr int kDecodeGroups = kDecodeThreads / kDecodeCols;  // row groups
constexpr int kMaxState = 128;          // largest N
static_assert(kChunkThreads % kQ == 0 && kQ % kRowBlocks == 0, "tiles");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// kV consecutive floats of a state row: one 16-byte load, or one float
template <int kV>
__device__ __forceinline__ void load_state(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) v[e] = p[e];
  }
}
template <int kV>
__device__ __forceinline__ void store_state(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) p[e] = v[e];
  }
}

// kR consecutive floats of a shared-memory row (16-byte aligned when kR is
// a multiple of 4) into registers
template <int kR>
__device__ __forceinline__ void load_row(const float* p, float (&v)[kR]) {
  if constexpr (kR % 4 == 0) {
#pragma unroll
    for (int r = 0; r < kR; r += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + r);
      v[r] = u.x; v[r + 1] = u.y; v[r + 2] = u.z; v[r + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = p[r];
  }
}

// Steps c0 .. c0 + kRows - 1 of a (B, S, G, N) array's group g into shared
// memory dst[step][ld] as float32, zeros past the chunk (nq steps) and past
// N; 16 loads a thread in flight before their stores.
template <int kRows, int kCols, int kLd, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int b, int S, int G,
                                           int g, int N, int c0, int nq,
                                           int tid) {
  constexpr int kLoads = kRows * kCols / kChunkThreads;
  constexpr int kBatch = kLoads < 16 ? kLoads : 16;
#pragma unroll
  for (int k0 = 0; k0 < kLoads; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = tid + (k0 + k) * kChunkThreads;
      const int j = i / kCols, n = i % kCols;
      v[k] = (j < nq && n < N)
                 ? to_f32(src[(((size_t)b * S + c0 + j) * G + g) * N + n])
                 : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = tid + (k0 + k) * kChunkThreads;
      dst[(i / kCols) * kLd + i % kCols] = v[k];
    }
  }
}

// Columns p0 .. p0 + kCols - 1 of head h of x (B, S, H, P) over the chunk's
// steps into dst[step][kCols] as float32, zeros past the chunk and past P.
template <int kRows, int kCols, typename T>
__device__ __forceinline__ void stage_cols(const T* __restrict__ x,
                                           float* dst, int b, int S, int H,
                                           int h, int P, int p0, int c0,
                                           int nq, int tid) {
  constexpr int kLoads = kRows * kCols / kChunkThreads;
  constexpr int kBatch = kLoads < 16 ? kLoads : 16;
#pragma unroll
  for (int k0 = 0; k0 < kLoads; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = tid + (k0 + k) * kChunkThreads;
      const int j = i / kCols, p = p0 + i % kCols;
      v[k] = (j < nq && p < P)
                 ? to_f32(x[(((size_t)b * S + c0 + j) * H + h) * P + p])
                 : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      dst[tid + (k0 + k) * kChunkThreads] = v[k];
  }
}

// ---------------------------------------------------------------------------
// decode path
// ---------------------------------------------------------------------------

// grid (ceil(P / kV / kDecodeCols), H, B).  x, y (B, S, H, P); dA (B, S, H);
// Bm, Cm (B, S, G, N); init (B, H, N, P) or null; fin (B, H, N, P).
template <typename T, int kV>
__global__ void
ssd_decode(const T* __restrict__ x, const float* __restrict__ dA,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ fin, int S, int H, int P, int G, int N) {
  constexpr int kRows = kMaxState / kDecodeGroups;  // state rows a thread
  constexpr int kW = kDecodeThreads / 32;
  __shared__ float bc_s[kDecodeMaxS][2][kMaxState];
  __shared__ float x_s[kDecodeMaxS][kDecodeCols * kV];
  __shared__ float a_s[kDecodeMaxS];
  __shared__ float red[2][kW][kDecodeCols][kV];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cu = tid % kDecodeCols;       // column unit within the CTA
  const int rg = tid / kDecodeCols;       // row group: rows rg + 32 r
  const int u0 = blockIdx.x * kDecodeCols;
  const bool ok = u0 + cu < P / kV;
  const size_t srow = ((size_t)b * H + h) * N;  // the head's row 0

  float hr[kRows][kV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = rg + kDecodeGroups * r;
#pragma unroll
    for (int e = 0; e < kV; ++e) hr[r][e] = 0.f;
    if (init != nullptr && ok && n < N)
      load_state<kV>(init + (srow + n) * P + (size_t)(u0 + cu) * kV, hr[r]);
  }
  for (int i = tid; i < S * N; i += kDecodeThreads) {
    const int t = i / N, n = i % N;
    const size_t o = (((size_t)b * S + t) * G + g) * N + n;
    bc_s[t][0][n] = to_f32(Bm[o]);
    bc_s[t][1][n] = to_f32(Cm[o]);
  }
  for (int i = tid; i < S * kDecodeCols * kV; i += kDecodeThreads) {
    const int t = i / (kDecodeCols * kV), e = i % (kDecodeCols * kV);
    const int p = u0 * kV + e;
    x_s[t][e] = p < P ? to_f32(x[(((size_t)b * S + t) * H + h) * P + p])
                      : 0.f;
  }
  for (int t = tid; t < S; t += kDecodeThreads)
    a_s[t] = expf(dA[((size_t)b * S + t) * H + h]);
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float a = a_s[t];
    float yp[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) yp[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = rg + kDecodeGroups * r;
      if (n < N) {
        const float bv = bc_s[t][0][n], cv = bc_s[t][1][n];
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float hn = fmaf(a, hr[r][e], bv * x_s[t][cu * kV + e]);
          hr[r][e] = hn;
          yp[e] = fmaf(cv, hn, yp[e]);
        }
      }
    }
    // sum over the warp's 8 row groups (lane = 4 x row group + unit) ...
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      yp[e] += __shfl_xor_sync(0xffffffffu, yp[e], 4);
      yp[e] += __shfl_xor_sync(0xffffffffu, yp[e], 8);
      yp[e] += __shfl_xor_sync(0xffffffffu, yp[e], 16);
    }
    if (lane < kDecodeCols)
#pragma unroll
      for (int e = 0; e < kV; ++e) red[t & 1][warp][lane][e] = yp[e];
    __syncthreads();
    // ... and over the warps (red is double-buffered: one barrier a step)
    if (tid < kDecodeCols && u0 + tid < P / kV) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kW; ++w) v += red[t & 1][w][tid][e];
        y[(((size_t)b * S + t) * H + h) * P + (size_t)(u0 + tid) * kV + e] =
            from_f32<T>(v);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = rg + kDecodeGroups * r;
    if (ok && n < N)
      store_state<kV>(fin + (srow + n) * P + (size_t)(u0 + cu) * kV, hr[r]);
  }
}

// ---------------------------------------------------------------------------
// chunk path: the workspace
// ---------------------------------------------------------------------------

// Float32 workspace of the chunk path, nc = ceil(S / kQ) chunks, n_ps =
// ceil(P / kPs) column slices; the wrapper allocates chunk_floats(...).
//   st   (B, nc, H, n_ps, N, kPs)  chunk-local states, then h_prev (in place)
//   cs   (B, nc, H, kQ)            running sums of dA in the chunk
//   cbt  (B, nc, G, kQ, kQ)        [j][i] = C_i . B_j
//   ct   (B, nc, G, N, kQ)         [n][i] = C_i[n]
struct Work {
  float* st;
  float* cs;
  float* cbt;
  float* ct;
  __host__ __device__ Work(float* ws, int B, int nc, int H, int n_ps, int G,
                           int N)
      : st(ws),
        cs(st + (size_t)B * nc * H * n_ps * N * kPs),
        cbt(cs + (size_t)B * nc * H * kQ),
        ct(cbt + (size_t)B * nc * G * kQ * kQ) {}
  static __host__ __device__ size_t floats(int B, int nc, int H, int n_ps,
                                           int G, int N) {
    return (size_t)B * nc *
           ((size_t)H * n_ps * N * kPs + (size_t)H * kQ +
            (size_t)G * kQ * kQ + (size_t)G * N * kQ);
  }
};

template <int kMaxN>
struct ChunkSmem {
  // (a): x o w [kQ][kPs], B [kQ][kMaxN], cs [kQ]; the group CTA: C and B
  // [kQ][kMaxN + 1]
  static constexpr int kHead = 4 * (kQ * kPs + kQ * kMaxN + 2 * kQ);
  static constexpr int kGroup = 4 * 2 * kQ * (kMaxN + 1);
  static constexpr int kState = kHead > kGroup ? kHead : kGroup;
  // (c): (C B^T o L) [kQ][kQ] as [j][i], x [kQ][kPs], C^T [kMaxN][kQ], h_prev
  // [kMaxN][kPs], cs and exp(cs) [kQ]
  static constexpr int kOut =
      4 * (kQ * kQ + kQ * kPs + kMaxN * kQ + kMaxN * kPs + 2 * kQ);
};

// ---------------------------------------------------------------------------
// (a) chunk-local states, decays, C B^T and C^T
// ---------------------------------------------------------------------------

// grid (nc, H * n_ps + G, B)
template <typename T, int kMaxN>
__global__ void
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ ws, int B, int S, int H, int P, int G,
                int N, int nc, int n_ps) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = c * kQ;
  const int nq = min(kQ, S - c0);
  const Work w(ws, B, nc, H, n_ps, G, N);
  const int cb = tid % 16, rb = tid / 16;  // 16 column x kRowBlocks row blocks

  if (blockIdx.y >= H * n_ps) {  // the group's C B^T and C^T
    const int g = blockIdx.y - H * n_ps;
    constexpr int kLd = kMaxN + 1;
    float* c_s = sm;             // [kQ][kLd]
    float* b_s = sm + kQ * kLd;  // [kQ][kLd]
    stage_rows<kQ, kMaxN, kLd>(Cm, c_s, b, S, G, g, N, c0, nq, tid);
    stage_rows<kQ, kMaxN, kLd>(Bm, b_s, b, S, G, g, N, c0, nq, tid);
    __syncthreads();
    const size_t bcg = ((size_t)b * nc + c) * G + g;
    float* ct = w.ct + bcg * N * kQ;
    for (int i = tid; i < N * kQ; i += kChunkThreads)
      ct[i] = c_s[(i % kQ) * kLd + i / kQ];
    // C B^T: rows i = kR rb + a, columns j = 4 cb + q
    constexpr int kR = kQ / kRowBlocks;
    float acc[kR][4];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[kR], bv[4];
#pragma unroll
      for (int a = 0; a < kR; ++a) cv[a] = c_s[(kR * rb + a) * kLd + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = b_s[(4 * cb + q) * kLd + n];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(cv[a], bv[q], acc[a][q]);
    }
    float* cbt = w.cbt + bcg * kQ * kQ;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < kR; a += 4)
        *reinterpret_cast<float4*>(cbt + (4 * cb + q) * kQ + kR * rb + a) =
            make_float4(acc[a][q], acc[a + 1][q], acc[a + 2][q],
                        acc[a + 3][q]);
    return;
  }

  const int h = blockIdx.y / n_ps;
  const int ps = blockIdx.y % n_ps;
  const int g = h / (H / G);
  float* xw = sm;                  // [kQ][kPs]: x o exp(cs_last - cs)
  float* b_s = xw + kQ * kPs;      // [kQ][kMaxN]
  float* cs_s = b_s + kQ * kMaxN;  // [kQ]
  float* w_s = cs_s + kQ;          // [kQ]: exp(cs_last - cs)
  stage_rows<kQ, kMaxN, kMaxN>(Bm, b_s, b, S, G, g, N, c0, nq, tid);
  stage_cols<kQ, kPs>(x, xw, b, S, H, h, P, ps * kPs, c0, nq, tid);
  if (tid < 32) {  // the chunk's decays: warp scans, 2 steps a lane
    const size_t o = ((size_t)b * S + c0 + 2 * tid) * H + h;
    const float a0 = 2 * tid < nq ? dA[o] : 0.f;
    const float a1 = 2 * tid + 1 < nq ? dA[o + H] : 0.f;
    float v = a0 + a1, u = a0 + a1;  // prefix and suffix sums of the pairs
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float pv = __shfl_up_sync(0xffffffffu, v, d);
      const float su = __shfl_down_sync(0xffffffffu, u, d);
      if (tid >= d) v += pv;
      if (tid + d < 32) u += su;
    }
    float before = __shfl_up_sync(0xffffffffu, v, 1);
    float after = __shfl_down_sync(0xffffffffu, u, 1);
    if (tid == 0) before = 0.f;
    if (tid == 31) after = 0.f;
    cs_s[2 * tid] = before + a0;
    cs_s[2 * tid + 1] = v;
    // exp(cs_last - cs_j) as the sum of the steps after j, never as a
    // difference of running sums: those reach thousands at large decays,
    // and a difference of two would lose the small segments that matter
    w_s[2 * tid] = expf(a1 + after);
    w_s[2 * tid + 1] = expf(after);
  }
  __syncthreads();
  if (ps == 0 && tid < kQ)
    w.cs[(((size_t)b * nc + c) * H + h) * kQ + tid] = cs_s[tid];
  for (int i = tid; i < kQ * kPs; i += kChunkThreads) xw[i] *= w_s[i / kPs];
  __syncthreads();
  // state rows kRn rb .. kRn rb + kRn - 1, columns 4 cb .. 4 cb + 3
  constexpr int kRn = kMaxN / kRowBlocks;
  float acc[kRn][4];
#pragma unroll
  for (int r = 0; r < kRn; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < nq; ++j) {
    const float4 xv = *reinterpret_cast<const float4*>(xw + j * kPs + 4 * cb);
    float bv[kRn];
    load_row<kRn>(b_s + j * kMaxN + rb * kRn, bv);
#pragma unroll
    for (int r = 0; r < kRn; ++r) {
      acc[r][0] = fmaf(bv[r], xv.x, acc[r][0]);
      acc[r][1] = fmaf(bv[r], xv.y, acc[r][1]);
      acc[r][2] = fmaf(bv[r], xv.z, acc[r][2]);
      acc[r][3] = fmaf(bv[r], xv.w, acc[r][3]);
    }
  }
  float* st = w.st + ((((size_t)b * nc + c) * H + h) * n_ps + ps) * N * kPs;
#pragma unroll
  for (int r = 0; r < kRn; ++r) {
    const int n = rb * kRn + r;
    if (n < N)
      *reinterpret_cast<float4*>(st + n * kPs + 4 * cb) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---------------------------------------------------------------------------
// (b) the state pass over the chunks
// ---------------------------------------------------------------------------

// grid (ceil(N * kPs / 4 / kPassThreads) * n_ps, H, B).  vec: P % 4 == 0 and
// init / fin 16-byte aligned.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ init, float* __restrict__ fin,
               float* __restrict__ ws, int B, int H, int P, int G, int N,
               int nc, int n_ps, int vec) {
  const int ps = blockIdx.x % n_ps;
  const int e4 = (blockIdx.x / n_ps) * kPassThreads + threadIdx.x;
  if (e4 >= N * (kPs / 4)) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = e4 / (kPs / 4);
  const int p = ps * kPs + 4 * (e4 % (kPs / 4));
  const Work w(ws, B, nc, H, n_ps, G, N);
  const size_t srow = (((size_t)b * H + h) * N + n) * P;  // (B, H, N, P)
  const bool full = vec && p + 4 <= P;
  float hv[4] = {0.f, 0.f, 0.f, 0.f};
  if (init != nullptr) {
    if (full) {
      load_state<4>(init + srow + p, hv);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e < P) hv[e] = init[srow + p + e];
    }
  }
  const size_t cstride = (size_t)H * n_ps * N * kPs;  // one chunk further
  float* st = w.st + (((size_t)b * nc * H + h) * n_ps + ps) * N * kPs +
              n * kPs + (p - ps * kPs);
  const float* cs = w.cs + ((size_t)b * nc * H + h) * kQ + kQ - 1;
  for (int c0 = 0; c0 < nc; c0 += kPre) {
    float4 sl[kPre];
    float dec[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      if (c0 + k < nc) {
        sl[k] = *reinterpret_cast<const float4*>(st + (c0 + k) * cstride);
        dec[k] = cs[(size_t)(c0 + k) * H * kQ];
      }
    }
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(st + (c0 + k) * cstride) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        const float d = expf(dec[k]);
        hv[0] = fmaf(d, hv[0], sl[k].x);
        hv[1] = fmaf(d, hv[1], sl[k].y);
        hv[2] = fmaf(d, hv[2], sl[k].z);
        hv[3] = fmaf(d, hv[3], sl[k].w);
      }
    }
  }
  if (full) {
    store_state<4>(fin + srow + p, hv);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < P) fin[srow + p + e] = hv[e];
  }
}

// ---------------------------------------------------------------------------
// (c) the chunk outputs
// ---------------------------------------------------------------------------

// grid (nc, H * n_ps, B)
template <typename T, int kMaxN>
__global__ void
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dA,
              float* __restrict__ ws, T* __restrict__ y, int B, int S, int H,
              int P, int G, int N, int nc, int n_ps) {
  extern __shared__ __align__(16) float sm[];
  float* mt = sm;                  // [kQ (j)][kQ (i)]
  float* xs = mt + kQ * kQ;        // [kQ][kPs]
  float* ct = xs + kQ * kPs;       // [kMaxN][kQ]
  float* hs = ct + kMaxN * kQ;     // [kMaxN][kPs]
  float* a_s = hs + kMaxN * kPs;   // [kQ]: the chunk's dA
  float* e_s = a_s + kQ;           // [kQ]: exp(cs)
  const int c = blockIdx.x;
  const int h = blockIdx.y / n_ps;
  const int ps = blockIdx.y % n_ps;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int c0 = c * kQ;
  const int nq = min(kQ, S - c0);
  const Work w(ws, B, nc, H, n_ps, G, N);
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const size_t bcg = ((size_t)b * nc + c) * G + g;

  // the float32 tiles by cp.async (C B^T into mt, C^T, h_prev), x through
  // registers
  const float* cbt = w.cbt + bcg * kQ * kQ;
  const float* ctg = w.ct + bcg * N * kQ;
  const float* hg = w.st + (bch * n_ps + ps) * N * kPs;
  for (int i = tid; i < kQ * kQ / 4; i += kChunkThreads)
    cp_async16(mt + 4 * i, cbt + 4 * i, true);
  for (int i = tid; i < N * kQ / 4; i += kChunkThreads)
    cp_async16(ct + 4 * i, ctg + 4 * i, true);
  for (int i = tid; i < N * kPs / 4; i += kChunkThreads)
    cp_async16(hs + 4 * i, hg + 4 * i, true);
  cp_async_commit();
  stage_cols<kQ, kPs>(x, xs, b, S, H, h, P, ps * kPs, c0, nq, tid);
  if (tid < kQ) {
    a_s[tid] = tid < nq ? dA[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    e_s[tid] = expf(w.cs[bch * kQ + tid]);
  }
  cp_async_wait<0>();
  __syncthreads();
  {  // mt[j][r] = C_r . B_j exp(dA_{j+1} + ... + dA_r) for j <= r < nq: the
     // segment summed step by step (as w in (a)), thread (r, part of j)
    constexpr int kParts = kChunkThreads / kQ;
    const int r = tid % kQ;
    const int jlo = (tid / kQ) * (kQ / kParts), jhi = jlo + kQ / kParts - 1;
    float seg = 0.f;
    for (int k = jhi + 1; k <= r; ++k) seg += a_s[k];
    for (int j = jhi; j >= jlo; --j) {
      const int i = j * kQ + r;
      mt[i] = (j <= r && r < nq) ? mt[i] * expf(seg) : 0.f;
      if (j <= r) seg += a_s[j];
    }
  }
  __syncthreads();
  // y rows kR ib .. kR ib + kR - 1, columns 4 cb .. 4 cb + 3
  constexpr int kR = kQ / kRowBlocks;
  const int ib = tid / 16, cb = tid % 16;
  float yd[kR][4], yo[kR][4];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) yd[a][q] = yo[a][q] = 0.f;
  const int jmax = min(kR * ib + kR, nq);
#pragma unroll 4
  for (int j = 0; j < jmax; ++j) {
    float mv[kR];
    load_row<kR>(mt + j * kQ + kR * ib, mv);
    const float4 x4 = *reinterpret_cast<const float4*>(xs + j * kPs + 4 * cb);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) yd[a][q] = fmaf(mv[a], xv[q], yd[a][q]);
  }
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[kR];
    load_row<kR>(ct + n * kQ + kR * ib, cv);
    const float4 h4 = *reinterpret_cast<const float4*>(hs + n * kPs + 4 * cb);
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) yo[a][q] = fmaf(cv[a], hv[q], yo[a][q]);
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = kR * ib + a;
    if (i < nq) {
      T* yr = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = ps * kPs + 4 * cb + q;
        if (p < P) yr[p] = from_f32<T>(fmaf(yo[a][q], e_s[i], yd[a][q]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_decode(const void* x, const float* dA, const void* Bm,
                          const void* Cm, const float* init, void* y,
                          float* fin, int B, int S, int H, int P, int G, int N,
                          bool vec, cudaStream_t s) {
  const int kV = vec ? 4 : 1;
  const int units = P / kV;
  const dim3 grid((units + kDecodeCols - 1) / kDecodeCols, H, B);
  if (vec)
    ssd_decode<T, 4><<<grid, kDecodeThreads, 0, s>>>(
        static_cast<const T*>(x), dA, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), init, static_cast<T*>(y), fin, S, H, P, G,
        N);
  else
    ssd_decode<T, 1><<<grid, kDecodeThreads, 0, s>>>(
        static_cast<const T*>(x), dA, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), init, static_cast<T*>(y), fin, S, H, P, G,
        N);
  return cudaGetLastError();
}

template <typename T, int kMaxN>
cudaError_t launch_chunks(const void* x, const float* dA, const void* Bm,
                          const void* Cm, const float* init, void* y,
                          float* fin, float* ws, int B, int S, int H, int P,
                          int G, int N, bool vec, cudaStream_t s) {
  const int nc = (S + kQ - 1) / kQ;
  const int n_ps = (P + kPs - 1) / kPs;
  constexpr int smem_a = ChunkSmem<kMaxN>::kState;
  constexpr int smem_c = ChunkSmem<kMaxN>::kOut;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<T, kMaxN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out<T, kMaxN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<T, kMaxN>
      <<<dim3(nc, H * n_ps + G, B), kChunkThreads, smem_a, s>>>(
          static_cast<const T*>(x), dA, static_cast<const T*>(Bm),
          static_cast<const T*>(Cm), ws, B, S, H, P, G, N, nc, n_ps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_rb = (N * (kPs / 4) + kPassThreads - 1) / kPassThreads;
  ssd_state_pass<<<dim3(n_rb * n_ps, H, B), kPassThreads, 0, s>>>(
      init, fin, ws, B, H, P, G, N, nc, n_ps, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_out<T, kMaxN><<<dim3(nc, H * n_ps, B), kChunkThreads, smem_c, s>>>(
      static_cast<const T*>(x), dA, ws, static_cast<T*>(y), B, S, H, P, G, N,
      nc, n_ps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const float* dA, const void* Bm,
                     const void* Cm, const float* init, void* y, float* fin,
                     float* ws, int B, int S, int H, int P, int G, int N,
                     bool vec, cudaStream_t s) {
  if (S <= kDecodeMaxS)
    return launch_decode<T>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N,
                            vec, s);
  if (N <= 16)
    return launch_chunks<T, 16>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P,
                                G, N, vec, s);
  if (N <= 32)
    return launch_chunks<T, 32>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P,
                                G, N, vec, s);
  if (N <= 64)
    return launch_chunks<T, 64>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P,
                                G, N, vec, s);
  return launch_chunks<T, 128>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P,
                               G, N, vec, s);
}

template <typename T>
cudaError_t resources_t(int kernel, int N, int* out) {
  const int n = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  switch (kernel * 1000 + n) {
    case 16: case 32: case 64: case 128:
      return resources(ssd_decode<T, 4>, kDecodeThreads, 0, out);
    case 1016: return resources(ssd_chunk_state<T, 16>, kChunkThreads,
                                ChunkSmem<16>::kState, out);
    case 1032: return resources(ssd_chunk_state<T, 32>, kChunkThreads,
                                ChunkSmem<32>::kState, out);
    case 1064: return resources(ssd_chunk_state<T, 64>, kChunkThreads,
                                ChunkSmem<64>::kState, out);
    case 1128: return resources(ssd_chunk_state<T, 128>, kChunkThreads,
                                ChunkSmem<128>::kState, out);
    case 2016: case 2032: case 2064: case 2128:
      return resources(ssd_state_pass, kPassThreads, 0, out);
    case 3016: return resources(ssd_chunk_out<T, 16>, kChunkThreads,
                                ChunkSmem<16>::kOut, out);
    case 3032: return resources(ssd_chunk_out<T, 32>, kChunkThreads,
                                ChunkSmem<32>::kOut, out);
    case 3064: return resources(ssd_chunk_out<T, 64>, kChunkThreads,
                                ChunkSmem<64>::kOut, out);
    case 3128: return resources(ssd_chunk_out<T, 128>, kChunkThreads,
                                ChunkSmem<128>::kOut, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  init may be null.
// ws: ws_floats floats of workspace for the chunk path (S > kDecodeMaxS),
// ssd_scan_workspace(B, S, H, P, G, N) of them; null (0) for the decode
// path.  Issues one kernel (decode) or three (chunks).  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const float* dA, const void* Bm,
                               const void* Cm, const float* init, void* y,
                               float* fin, float* ws, long long ws_floats,
                               int B, int S, int H, int P, int G, int N,
                               int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || S < 0)
    return cudaErrorInvalidValue;
  if (H % G != 0 || N > kMaxState || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (fin == nullptr) return cudaErrorInvalidValue;
  const int n_ps = (P + kPs - 1) / kPs;
  if (S > kDecodeMaxS) {
    const int nc = (S + kQ - 1) / kQ;
    if ((long long)H * n_ps + G > 65535) return cudaErrorInvalidValue;
    if (ws == nullptr ||
        (unsigned long long)ws_floats < Work::floats(B, nc, H, n_ps, G, N))
      return cudaErrorInvalidValue;
  }
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(fin) % 16 == 0 &&
                   (init == nullptr ||
                    reinterpret_cast<uintptr_t>(init) % 16 == 0);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P, G, N,
                           vec, s);
  return launch_n<__nv_bfloat16>(x, dA, Bm, Cm, init, y, fin, ws, B, S, H, P,
                                 G, N, vec, s);
}

// Floats of workspace the chunk path needs (0 for the decode path).
extern "C" long long ssd_scan_workspace(int B, int S, int H, int P, int G,
                                        int N) {
  if (S <= kDecodeMaxS) return 0;
  return (long long)Work::floats(B, (S + kQ - 1) / kQ, H, (P + kPs - 1) / kPs,
                                 G, N);
}

// out[5]: the `resources` of one kernel of the scan for (N, dtype): kernel
// 0 the decode path (16-byte state vectors), 1 (a) ssd_chunk_state, 2 (b)
// ssd_state_pass, 3 (c) ssd_chunk_out.
extern "C" int ssd_scan_resources(int kernel, int N, int dtype, int device,
                                  int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return resources_t<float>(kernel, N, out);
  if (dtype == 1) return resources_t<__nv_bfloat16>(kernel, N, out);
  return cudaErrorInvalidValue;
}
