// Paged chunk attention on the head-feature rung of tensor-parallel serving,
// for Hopper (sm_90a): kernel 1's and B.2's feature-shard modes.
//
// Where the serving pool's kv heads do not divide over the shards and its
// page rows do not either, ShardingPlan.pool_spec cuts the pool along the
// head dim D: shard r holds features [r * DR, (r + 1) * DR) of every row of
// every page and kv head.  The JAX package serves that pool by letting
// GSPMD partition the attention oracle along D (on that rung the TPU
// kernels `paged_chunk_attention` and `paged_chunk_attention_quant` of
// src/repro/kernels/paged_attention.py do not run; the oracle stands in for
// them): each device forms its partial scores q_r . k_r, an all-reduce sums
// them, and each device applies the softmax and multiplies by its own V
// features, giving its D slice of the output.  Two kernels do the same,
// shard by shard, each with a kQuant variant that reads flagged pages from
// the shard's int8 shadow pools times the page's float32 scale (the full
// page's scale, the same on every shard):
//
//   * F1, paged_chunk_scores_launch: scores[b][h][i][kpos] = q_r[b][i][h] .
//     k_r[kpos] (unscaled, float32) for every key a query row can see, read
//     through the lane's block-table row; with `accumulate` it adds into
//     the buffer, so that the shards of one card sum into one buffer in
//     stream order (shard 0 writes, shards 1..n-1 add).  Entries of keys a
//     row cannot see (kpos > qpos, kpos >= ctx, or a padding row qpos >=
//     ctx) are not written: the table may name any page past a lane's
//     relevant ones, and F2 never reads those entries.
//   * F2, paged_chunk_softmax_pv_launch: for every query row, the float32
//     softmax of the summed scores times 1 / sqrt(D) of the FULL head over
//     the visible keys kpos <= min(qpos, ctx - 1), masked by position and
//     never by page id, times the shard's V features: o_r[b][i][h][DR] in
//     V's dtype.  Padding rows and ctx = 0 lanes are written as zeros.
//
// What bounds them.  At DR of 2-16 a key's features are 4-32 bytes and a
// (query row, head, key) costs 2 DR operations in F1 and about 2 DR + 4 in
// F2, while F1 writes (and, accumulating, reads) 4 bytes of scores for it
// and F2 reads them: both are bound by the scores' bytes, B * H * Sq * T * 4
// a shard, not by products (a k-dim of 8 would fill a sixteenth of a
// wgmma's, and float32 inputs must stay float32: phase 22 holds exact
// tokens).  So both run on the CUDA cores in float32 and are built around
// the scores' traffic: every score moves as part of a 16-byte access of 4
// consecutive keys by one thread, 512 contiguous bytes a warp, F1's with a
// streaming cache hint (the buffer, 1 GB at a long chunk, is touched once a
// pass and would only evict K and V from the 50 MB L2).  A lane owns 4
// consecutive keys of a 128-key warp tile (kTileKeys) in both kernels.
//
// Staging.  A key's features are read through the table once a CTA, in
// chunks of 16 bytes (8 or 4 where a row is shorter; an int8 row at DR 2 is
// 2 bytes), int8 rows multiplied by their page's scale, and kept as
// float32 in shared memory transposed to [DR][keys], so that a lane reads
// its 4 keys' feature d as one conflict-free float4.
//
// F1 (feature_scores): a CTA owns kTileKeys consecutive key positions of one
// (lane, kv head) and a part of the real query rows that see any of them
// (rows from max(0, k0 - qoff), cut into parts of about 256 (row, head)
// pairs by paged_attention.feature_scores_plan, so that a long chunk of
// few lanes still spreads over the card; the parts read the tile's keys
// from L2).  Over int8 shadows the tile's pages are read first, id, flag
// and scale once a page.  The rows' G heads of q are staged as float32 in
// chunks of rows.  A warp computes kF1Pairs (row, head) pairs x 4 keys a
// lane at a time, the pairs flattened over (row, head) so that G = 1 and G
// = 16 fill it alike, and writes each pair's 4 scores with one 16-byte
// store; with `accumulate` it issues the loads of all its pairs before any
// add.  A 4-key run the diagonal or ctx cuts (or a row length that is not
// a multiple of 4) is written score by score.
//
// F2 (feature_softmax_pv): a CTA owns a tile of PT = npg x kPairs (row,
// head) pairs of one (lane, kv head), the pairs sharing one V, and walks its
// keys in blocks of kw x kTileKeys: npg pair groups x kw key warps.  V's
// rows, as the pools hold them, and each warp's pairs' scores (16 bytes a
// lane) stream through kRing-stage cp.async rings, one commit group a
// block, so that two blocks are in flight while a block computes, and
// each thread dequantizes
// the V chunks it copied into the float32 block, once for all the CTA's
// pairs (two such blocks, one barrier a block).  Per lane and pair an
// online softmax (m, l, acc[DR]) is rescaled once per 4 keys, with no
// divergent branch (masked scores are -inf, m starts finite).  At the end
// each warp merges its lanes by shuffles, the CTA's key warps are merged in
// shared memory, and the cluster's CTAs by rank 0 over distributed shared
// memory.  At decode and short chunks, where B x Hkv x pair tiles falls
// short of the SMs, the plan (paged_attention.feature_pv_plan) splits the
// keys over the n_split <= 8 CTAs of a thread-block cluster, merged in the
// same launch.  A tile with no real row (bucket padding, a ctx = 0 lane)
// writes its zeros and exits.
//
// Launch functions return a cudaError_t (0 = launched); they check the
// launch with cudaGetLastError and never synchronise.  A geometry the
// kernel does not take, or a cluster the card refuses, is an error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileKeys = 128;      // keys a warp covers a step, 4 a lane
constexpr int kF1Warps = 4;         // F1: warps a CTA
constexpr int kF1Pairs = 4;         // F1: (row, head) pairs a warp at once
constexpr int kPvMaxWarps = 8;      // F2: npg x kw at most
constexpr int kPvMaxSplit = 8;      // F2: CTAs of a cluster (portable)
constexpr int kStageFloats = 8192;  // F2: V floats of one block (32 KiB)
constexpr int kRing = 3;            // F2: stages of the V and scores rings

template <int DR> struct F1 {
  // q floats a CTA stages (16 KiB; 8 at DR 64, beside 32 KiB of keys)
  static constexpr int kQFloats = DR >= 64 ? 2048 : 4096;
};
// F2: (row, head) pairs a warp carries through the key walk
template <int DR> struct Pv {
  static constexpr int kPairs = DR <= 8 ? 4 : DR == 16 ? 2 : 1;
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// A key row of DR features of T is gathered in kChunks chunks of kCE
// elements: kCE * sizeof(T) bytes from the fp pool (16, or the whole row
// when shorter), kCE bytes from the int8 shadow.
template <typename T, int DR> struct Rows {
  static constexpr int kCE =
      16 / static_cast<int>(sizeof(T)) < DR ? 16 / static_cast<int>(sizeof(T))
                                            : DR;
  static constexpr int kChunks = DR / kCE;
  static constexpr int kFpBytes = kCE * static_cast<int>(sizeof(T));
};

// N bytes at p (aligned to N), through the read-only path, in a uint4
template <int N>
__device__ __forceinline__ uint4 load_raw(const void* __restrict__ p) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (N == 16) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (N == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.x = v.x;
    r.y = v.y;
  } else if constexpr (N == 4) {
    r.x = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(N == 2, "chunks are 2, 4, 8 or 16 bytes");
    r.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

template <typename E, int N>
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[N]) {
  const E* e = reinterpret_cast<const E*>(&r);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
}

// One chunk of a key row at element offset `off` of the (P, page, Hkv, DR)
// pools: from the int8 shadow where the page is flagged (kQuant), else from
// the fp pool.
template <typename T, int DR, bool kQuant>
__device__ __forceinline__ uint4 fetch_chunk(const T* __restrict__ pages,
                                             const int8_t* __restrict__ qpages,
                                             long long off, bool flagged) {
  using R = Rows<T, DR>;
  if (kQuant && flagged) return load_raw<R::kCE>(qpages + off);
  return load_raw<R::kFpBytes>(pages + off);
}

template <typename T, int DR, bool kQuant>
__device__ __forceinline__ void convert_chunk(const uint4& raw, bool flagged,
                                              float scale,
                                              float (&out)[Rows<T, DR>::kCE]) {
  if (kQuant && flagged) {
    unpack<int8_t>(raw, out);
#pragma unroll
    for (int j = 0; j < Rows<T, DR>::kCE; ++j) out[j] *= scale;
  } else {
    unpack<T>(raw, out);
  }
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// cp.async of N = 4, 8 or 16 bytes (16 bypassing L1); with valid false
// nothing is read and the N bytes are zero-filled
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool valid) {
  if constexpr (N == 16) {
    cp_async16(dst, src, valid);
  } else {
    static_assert(N == 4 || N == 8, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0)
                 : "memory");
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: -inf gives 0, a result below 2^-126
// gives 0); x <= 0 here, a probability's exponent
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// min(a, b) of a key position and the table's length T_len, as an int
__device__ __forceinline__ int clamp_keys(int a, long long T_len) {
  return static_cast<int>(static_cast<long long>(a) < T_len ? a : T_len);
}

// ---------------------------------------------------------------------------
// F1: the shard's partial scores
// ---------------------------------------------------------------------------

template <typename T, int DR, bool kQuant>
__global__ void __launch_bounds__(kF1Warps * 32) feature_scores(
    const T* __restrict__ q, int qsb, int qss, int qsh, int qvec,
    const T* __restrict__ k_pages, const int8_t* __restrict__ kq_pages,
    const float* __restrict__ k_scales, const int* __restrict__ page_quant,
    const int* __restrict__ tables, const int* __restrict__ q_offsets,
    const int* __restrict__ ctx_lens, float* __restrict__ scores, int Sq,
    int H, int Hkv, int page, int T_width, int accumulate, int vec) {
  using R = Rows<T, DR>;
  constexpr int kQF = F1<DR>::kQFloats;
  constexpr bool kKeyRegs = DR <= 16;
  constexpr int kStep = DR < 4 ? DR : 4;   // features a q load
  __shared__ __align__(16) float ks[DR * kTileKeys];  // [d][key]
  __shared__ __align__(16) float qs[kQF];             // [row][g][d]
  __shared__ int pg_id[kQuant ? kTileKeys : 1];  // the tile's pages
  __shared__ float pg_scale[kQuant ? kTileKeys : 1];
  __shared__ int pg_flag[kQuant ? kTileKeys : 1];

  const int G = H / Hkv;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int qoff = q_offsets[b], ctx = ctx_lens[b];
  const long long T_len = (long long)T_width * page;
  // real rows [0, i_end): i < Sq and qpos = qoff + i < ctx
  const int i_end = min(Sq, ctx - qoff);
  if (i_end <= 0) return;
  // keys any real row sees
  const int kv_end = clamp_keys(min(ctx, qoff + i_end), T_len);
  const int k0 = blockIdx.x * kTileKeys;
  if (k0 >= kv_end) return;
  const int n_keys = min(kTileKeys, kv_end - k0);
  // the rows that see a key of the tile, [max(0, k0 - qoff), i_end) (not
  // empty, as k0 < kv_end), cut into gridDim.z parts: this CTA's
  const int i_lo = max(0, k0 - qoff);
  const int part = (i_end - i_lo + gridDim.z - 1) / gridDim.z;
  const int i_first = i_lo + blockIdx.z * part;
  const int i_stop = min(i_end, i_first + part);
  if (i_first >= i_stop) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = k0 + 4 * lane;  // this lane's first key

  // a warp's (row, head) pairs' 4 scores each, pairs [pb, min(pb +
  // kF1Pairs, n_pairs)) of those that start at row c0: written (or added)
  // where the pair's row sees the key
  auto store4 = [&](const float (&acc)[kF1Pairs][4], int pb, int c0,
                    int n_pairs) {
    int hz[kF1Pairs];  // the keys the pair's row sees: [0, hz)
    float* dst[kF1Pairs];
    int i = c0 + pb / G, g = pb % G;
#pragma unroll
    for (int j = 0; j < kF1Pairs; ++j) {
      hz[j] = pb + j < n_pairs ? min(kv_end, qoff + i + 1) : 0;
      dst[j] = scores + (((long long)b * H + hk * G + g) * Sq + i) * T_len +
               kq;
      if (++g == G) {
        g = 0;
        ++i;
      }
    }
    if (vec) {
      float4 old[kF1Pairs];
      if (accumulate) {
        // every pair's load before any add
#pragma unroll
        for (int j = 0; j < kF1Pairs; ++j) {
          const float4* src = reinterpret_cast<const float4*>(dst[j]);
          old[j] = kq + 4 <= hz[j] ? __ldcs(src)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < kF1Pairs; ++j) {
        if (kq + 4 <= hz[j]) {
          float4 o = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          if (accumulate) {
            o.x += old[j].x;
            o.y += old[j].y;
            o.z += old[j].z;
            o.w += old[j].w;
          }
          __stcs(reinterpret_cast<float4*>(dst[j]), o);
        } else if (kq < hz[j]) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (kq + k < hz[j])
              dst[j][k] = accumulate ? dst[j][k] + acc[j][k] : acc[j][k];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kF1Pairs; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (kq + k < hz[j])
            dst[j][k] = accumulate ? dst[j][k] + acc[j][k] : acc[j][k];
      }
    }
  };

  // q rows [c0, c0 + rows), the kv head's G heads, as float32 [row][g][d]
  auto stage_q = [&](int c0, int rows) {
    const int n_q = rows * G * DR;
    if (qvec) {
      constexpr int kPer = DR / R::kCE;
      for (int e = threadIdx.x; e < n_q / R::kCE; e += kF1Warps * 32) {
        const int d0 = (e % kPer) * R::kCE, g = (e / kPer) % G,
                  i = e / (kPer * G);
        const uint4 raw = load_raw<R::kFpBytes>(
            q + (long long)b * qsb + (long long)(c0 + i) * qss +
            (long long)(hk * G + g) * qsh + d0);
        float f[R::kCE];
        unpack<T>(raw, f);
#pragma unroll
        for (int j = 0; j < R::kCE; ++j) qs[(i * G + g) * DR + d0 + j] = f[j];
      }
    } else {
      for (int e = threadIdx.x; e < n_q; e += kF1Warps * 32) {
        const int d = e % DR, g = (e / DR) % G, i = e / (DR * G);
        qs[e] = to_f32(q[(long long)b * qsb + (long long)(c0 + i) * qss +
                         (long long)(hk * G + g) * qsh + d]);
      }
    }
  };
  // the key tile, float32, [d][key]; keys past kv_end are zeros (their
  // pages are not read).  Over fp pools each key reads its table entry
  // (a warp's keys share a page's, one request); over int8 shadows the
  // tile's pages (k0 is a multiple of the page) are read first, id, flag
  // and scale once a page, by the CTA's last threads.  Either way the
  // reads of pages overlap those of the first chunk of q rows.
  const int p0 = k0 / page;
  const int* trow = tables + (long long)b * T_width;
  int pg_first = 0;  // (fp) the page of this thread's first key
  if constexpr (kQuant) {
    const int t = kF1Warps * 32 - 1 - threadIdx.x;  // at most 128 pages
    if (t < (n_keys + page - 1) / page) {
      const int pg = trow[p0 + t];
      const int f = page_quant[pg] != 0;
      pg_id[t] = pg;
      pg_flag[t] = f;
      pg_scale[t] = f ? k_scales[pg] : 1.f;
    }
  } else {
    if (threadIdx.x < n_keys) pg_first = trow[p0 + threadIdx.x / page];
  }
  const int rc = max(1, kQF / (G * DR));  // rows a q chunk
  stage_q(i_first, min(rc, i_stop - i_first));
  if constexpr (kQuant) __syncthreads();
  for (int e = threadIdx.x; e < kTileKeys * R::kChunks; e += kF1Warps * 32) {
    const int kk = e % kTileKeys, c = e / kTileKeys;
    float v[R::kCE];
    if (kk < n_keys) {
      const int t = kk / page;
      const int kpos = k0 + kk;
      const bool f = kQuant && pg_flag[kQuant ? t : 0] != 0;
      const int pg = kQuant ? pg_id[kQuant ? t : 0]
                            : e == threadIdx.x ? pg_first : trow[p0 + t];
      const long long off =
          (((long long)pg * page + kpos % page) * Hkv + hk) * DR + c * R::kCE;
      const uint4 raw =
          fetch_chunk<T, DR, kQuant>(k_pages, kq_pages, off, f);
      convert_chunk<T, DR, kQuant>(raw, f, kQuant ? pg_scale[kQuant ? t : 0]
                                                  : 1.f, v);
    } else {
#pragma unroll
      for (int j = 0; j < R::kCE; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < R::kCE; ++j)
      ks[(c * R::kCE + j) * kTileKeys + kk] = v[j];
  }
  __syncthreads();

  const float4* ks4 = reinterpret_cast<const float4*>(ks) + lane;
  float4 kr[kKeyRegs ? DR : 1];
  if constexpr (kKeyRegs) {
#pragma unroll
    for (int d = 0; d < DR; ++d) kr[d] = ks4[d * (kTileKeys / 4)];
  }
  for (int c0 = i_first; c0 < i_stop; c0 += rc) {
    const int rows = min(rc, i_stop - c0);
    if (c0 != i_first) {
      __syncthreads();  // the last chunk's q is read
      stage_q(c0, rows);
      __syncthreads();
    }
    const int n_pairs = rows * G;
    // pairs a warp takes at once: kF1Pairs, or fewer where the chunk has
    // fewer than kF1Warps x kF1Pairs (decode), so that every warp stores
    const int np =
        min(kF1Pairs, max(1, (n_pairs + kF1Warps - 1) / kF1Warps));
    for (int pb = warp * np; pb < n_pairs; pb += kF1Warps * np) {
      float acc[kF1Pairs][4];
#pragma unroll
      for (int j = 0; j < kF1Pairs; ++j) {
        if (j >= np) break;  // the same for the whole CTA
        // a pair past the end recomputes the last one; it is not stored
        const float* qp = qs + min(pb + j, n_pairs - 1) * DR;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
        for (int d = 0; d < DR; d += kStep) {
          float qv[kStep];
          if constexpr (kStep == 4) {
            const float4 t = *reinterpret_cast<const float4*>(qp + d);
            qv[0] = t.x;
            qv[1] = t.y;
            qv[2] = t.z;
            qv[3] = t.w;
          } else {
#pragma unroll
            for (int dd = 0; dd < kStep; ++dd) qv[dd] = qp[d + dd];
          }
#pragma unroll
          for (int dd = 0; dd < kStep; ++dd) {
            const float4 kk =
                kKeyRegs ? kr[kKeyRegs ? d + dd : 0]
                         : ks4[(d + dd) * (kTileKeys / 4)];
            acc[j][0] = fmaf(qv[dd], kk.x, acc[j][0]);
            acc[j][1] = fmaf(qv[dd], kk.y, acc[j][1]);
            acc[j][2] = fmaf(qv[dd], kk.z, acc[j][2]);
            acc[j][3] = fmaf(qv[dd], kk.w, acc[j][3]);
          }
        }
      }
      store4(acc, pb, c0, min(n_pairs, pb + np));
    }
  }
}

// ---------------------------------------------------------------------------
// F2: softmax of the summed scores times the shard's V features
// ---------------------------------------------------------------------------

template <typename T, int DR, bool kQuant>
__global__ void __launch_bounds__(kPvMaxWarps * 32, 2) feature_softmax_pv(
    const float* __restrict__ scores, const T* __restrict__ v_pages,
    const int8_t* __restrict__ vq_pages, const float* __restrict__ v_scales,
    const int* __restrict__ page_quant, const int* __restrict__ tables,
    const int* __restrict__ q_offsets, const int* __restrict__ ctx_lens,
    T* __restrict__ out, int Sq, int H, int Hkv, int page, int T_width,
    float scale_log2, int npg, int kw, int split, int vec) {
  using R = Rows<T, DR>;
  constexpr int NPW = Pv<DR>::kPairs;
  constexpr bool kVRegs = DR <= 16;
  constexpr float kEmpty = -1e30f;  // m of a lane that saw no key
  extern __shared__ __align__(16) float smem[];  // V [2][DR][KB], slots
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int nthr = blockDim.x;  // 32 npg kw
  const int KB = kTileKeys * kw;
  const int PT = npg * NPW;
  // V [2][DR][KB] float32; V's raw rows [kRing][KB x kChunks chunks of
  // kFpBytes]; each warp's ring of scores [kRing][NPW][32 lanes] float4;
  // (kQuant) the raw chunks' scales [kRing][KB x kChunks]; slots [kw][PT][2
  // + DR] (each key warp's m, l, acc) and [PT][2 + DR] (merged)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* vraw = reinterpret_cast<unsigned char*>(smem + 2 * DR * KB);
  const int raw_stage = KB * R::kChunks * R::kFpBytes;
  float4* ring = reinterpret_cast<float4*>(vraw + kRing * raw_stage) +
                 warp * (kRing * NPW * 32) + lane;
  // (kQuant) each raw chunk's page scale, -1 for a chunk of the fp pool
  float* vscale = reinterpret_cast<float*>(
      reinterpret_cast<float4*>(vraw + kRing * raw_stage) +
      (nthr / 32) * (kRing * NPW * 32));
  float* slots = vscale + (kQuant ? kRing * KB * R::kChunks : 0);

  const int G = H / Hkv;
  const int b = blockIdx.z / Hkv, hk = blockIdx.z % Hkv;
  const int qoff = q_offsets[b], ctx = ctx_lens[b];
  const long long T_len = (long long)T_width * page;
  const int n_pairs = Sq * G;
  const int pt0 = blockIdx.y * PT;  // the tile's pairs [pt0, pt0 + PT)
  const int pgw = warp % npg, kwi = warp / npg;
  // keys this CTA walks: its split, below the horizon of the tile's last
  // real row
  const int i_lo = pt0 / G;
  const int i_hi = min(min((pt0 + PT - 1) / G, Sq - 1), ctx - qoff - 1);
  const int hz_tile =
      i_hi >= i_lo ? clamp_keys(min(ctx, qoff + i_hi + 1), T_len) : 0;
  if (hz_tile == 0) {  // no real row: the same for the cluster's CTAs
    if (rank == 0) {
      for (int e = threadIdx.x; e < PT * DR; e += nthr) {
        const int p = pt0 + e / DR;
        if (p < n_pairs)
          out[(((long long)b * Sq + p / G) * H + hk * G + p % G) * DR +
              e % DR] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const int ks = rank * split;
  const int ke = min(ks + split, hz_tile);

  // this warp's pairs: the keys each row sees ([0, hz)), its score row
  int hz[NPW];
  const float* srow[NPW];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int p = pt0 + pgw * NPW + j;
    const int i = p / G;
    const bool real = p < n_pairs && qoff + i < ctx;
    hz[j] = real ? clamp_keys(min(ctx, qoff + i + 1), T_len) : 0;
    srow[j] = scores + (((long long)b * H + hk * G + p % G) * Sq +
                        (real ? i : 0)) * T_len;
  }
  float m[NPW], l[NPW], acc[NPW][DR];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    m[j] = kEmpty;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DR; ++d) acc[j][d] = 0.f;
  }

  const int* trow = tables + (long long)b * T_width;
  const int n_blocks = ke > ks ? (ke - ks + KB - 1) / KB : 0;
  const int n_e = KB * R::kChunks;  // chunks of V a block
  // block t's V rows, as they are in the pools (int8 where the page is
  // flagged), into raw stage t % kRing by cp.async: element e of a block is
  // chunk e % kChunks of key e / kChunks, keys past ke zeros
  auto issue_v = [&](int t) {
    if (t < n_blocks) {
      const int kb = ks + t * KB;
      unsigned char* st = vraw + (t % kRing) * raw_stage;
      float* sst = vscale + (t % kRing) * n_e;
      // four elements at a time: their table entries (and flags and
      // scales) are read before any copy is issued
      for (int e0 = threadIdx.x; e0 < n_e; e0 += 4 * nthr) {
        int pg[4];
        bool ok[4], f[4];
        float sc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * nthr;
          const int kpos = kb + e / R::kChunks;
          ok[u] = e < n_e && kpos < ke;
          pg[u] = ok[u] ? trow[kpos / page] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          f[u] = kQuant && ok[u] && page_quant[pg[u]] != 0;
          sc[u] = kQuant && ok[u] ? v_scales[pg[u]] : 1.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * nthr;
          if (e >= n_e) break;
          const int kpos = kb + e / R::kChunks;
          const long long off =
              (((long long)pg[u] * page + kpos % page) * Hkv + hk) * DR +
              (e % R::kChunks) * R::kCE;
          void* dst = st + e * R::kFpBytes;
          if (kQuant) sst[e] = f[u] ? sc[u] : -1.f;
          if (!f[u]) {
            cp_async_n<R::kFpBytes>(dst, v_pages + off, ok[u]);
          } else if constexpr (R::kCE >= 4) {
            cp_async_n<R::kCE>(dst, vq_pages + off, true);
          } else {  // 2 bytes: no cp.async that small
            *reinterpret_cast<unsigned short*>(dst) =
                *reinterpret_cast<const unsigned short*>(vq_pages + off);
          }
        }
      }
    }
  };
  // this warp's pairs' scores of block t's 128 keys into its ring, 16 bytes
  // a lane (a row length that is not a multiple of 4: score by score, only
  // the scores a row sees)
  auto issue_s = [&](int t) {
    if (t < n_blocks) {
      const int kw0 = ks + t * KB + kwi * kTileKeys, kq = kw0 + 4 * lane;
      float4* sr = ring + (t % kRing) * (NPW * 32);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const bool any = kw0 < ke && kw0 < hz[j];
        if (vec) {
          const bool ok = any && kq < T_len;
          cp_async16(sr + j * 32, ok ? srow[j] + kq : srow[j], ok);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool ok = any && kq + k < hz[j];
            cp_async_n<4>(reinterpret_cast<float*>(sr + j * 32) + k,
                          ok ? srow[j] + kq + k : srow[j], ok);
          }
        }
      }
    }
  };
  // block t's raw V rows (the ones this thread copied) dequantized into
  // the float32 buffer buf as [d][key]
  auto put = [&](int t, float* buf) {
    const unsigned char* st = vraw + (t % kRing) * raw_stage;
    const float* sst = vscale + (t % kRing) * n_e;
    for (int e = threadIdx.x; e < n_e; e += nthr) {
      const float sc = kQuant ? sst[e] : -1.f;  // < 0: an fp row
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (R::kFpBytes == 16) {
        raw = *reinterpret_cast<const uint4*>(st + e * 16);
      } else if constexpr (R::kFpBytes == 8) {
        const uint2 r2 = *reinterpret_cast<const uint2*>(st + e * 8);
        raw.x = r2.x;
        raw.y = r2.y;
      } else {
        raw.x = *reinterpret_cast<const unsigned int*>(st + e * 4);
      }
      float v[R::kCE];
      convert_chunk<T, DR, kQuant>(raw, sc >= 0.f, sc, v);
      const int kk = e / R::kChunks, c = e % R::kChunks;
#pragma unroll
      for (int j = 0; j < R::kCE; ++j) buf[(c * R::kCE + j) * KB + kk] = v[j];
    }
  };

  // commit group g holds block g's scores and V: while block t computes,
  // blocks t + 1 and t + 2 are in flight (V of t + 1 is dequantized after
  // t; holding V a block further ahead was no faster)
#pragma unroll
  for (int g = 0; g < kRing - 1; ++g) {
    issue_s(g);
    issue_v(g);
    cp_async_commit();
  }
  if (n_blocks > 0) {
    cp_async_wait<kRing - 2>();
    put(0, smem);
  }
  for (int t = 0; t < n_blocks; ++t) {
    __syncthreads();  // block t's V dequantized; block t - 1's buffer free
    const int kb = ks + t * KB;
    issue_s(t + kRing - 1);
    issue_v(t + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 2>();  // block t's scores and t + 1's V are in
    const float* cur = smem + (t & 1) * DR * KB;
    const int kw0 = kb + kwi * kTileKeys;  // this warp's 128 keys
    if (kw0 < ke) {
      const int kq = kw0 + 4 * lane;
      const float4* st = ring + (t % kRing) * (NPW * 32);
      const float4* cv =
          reinterpret_cast<const float4*>(cur + kwi * kTileKeys) + lane;
      float4 v[kVRegs ? DR : 1];
      if constexpr (kVRegs) {
#pragma unroll
        for (int d = 0; d < DR; ++d) v[d] = cv[d * (KB / 4)];
      }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        if (kw0 >= hz[j]) continue;  // the same for the whole warp
        const float4 sj = st[j * 32];
        float s0 = sj.x, s1 = sj.y, s2 = sj.z, s3 = sj.w;
        if (kw0 + kTileKeys > hz[j]) {  // the row's horizon cuts the tile
          s0 = kq < hz[j] ? s0 : neg_inf();
          s1 = kq + 1 < hz[j] ? s1 : neg_inf();
          s2 = kq + 2 < hz[j] ? s2 : neg_inf();
          s3 = kq + 3 < hz[j] ? s3 : neg_inf();
        }
        // the scale is positive: the maximum of the scaled scores is the
        // scaled maximum
        const float mn = fmaxf(
            m[j], fmaxf(fmaxf(s0, s1), fmaxf(s2, s3)) * scale_log2);
        const float c = fast_exp2(m[j] - mn);
        const float p0 = fast_exp2(fmaf(s0, scale_log2, -mn)),
                    p1 = fast_exp2(fmaf(s1, scale_log2, -mn)),
                    p2 = fast_exp2(fmaf(s2, scale_log2, -mn)),
                    p3 = fast_exp2(fmaf(s3, scale_log2, -mn));
        l[j] = fmaf(l[j], c, (p0 + p1) + (p2 + p3));
#pragma unroll
        for (int d = 0; d < DR; ++d) {
          const float4 vd = kVRegs ? v[kVRegs ? d : 0] : cv[d * (KB / 4)];
          acc[j][d] = fmaf(acc[j][d], c,
                           fmaf(p0, vd.x,
                                fmaf(p1, vd.y, fmaf(p2, vd.z, p3 * vd.w))));
        }
        m[j] = mn;
      }
    }
    if (t + 1 < n_blocks) put(t + 1, smem + ((t + 1) & 1) * DR * KB);
  }
  cp_async_wait<0>();

  // each warp's lanes merged by shuffles into its slots
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    float* slot = slots + (kwi * PT + pgw * NPW + j) * (2 + DR);
    if (ks >= min(ke, hz[j])) {  // no key walked: an empty slot
      for (int d = lane; d < 2 + DR; d += 32)
        slot[d] = d == 0 ? kEmpty : 0.f;
      continue;
    }
    float M = m[j];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
    const float c = exp2f(m[j] - M);
    float L = l[j] * c;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) L += __shfl_xor_sync(0xffffffffu, L, w);
    if (lane == 0) {
      slot[0] = M;
      slot[1] = L;
    }
#pragma unroll
    for (int d = 0; d < DR; ++d) {
      float a = acc[j][d] * c;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
      if (lane == (d & 31)) slot[2 + d] = a;
    }
  }
  __syncthreads();
  // the CTA's key warps merged into one slot a pair, [PT][2 + DR]
  float* merged = slots + kw * PT * (2 + DR);
  for (int e = threadIdx.x; e < PT * DR; e += nthr) {
    const int pl = e / DR, d = e % DR;
    float M = kEmpty;
    for (int w = 0; w < kw; ++w)
      M = fmaxf(M, slots[(w * PT + pl) * (2 + DR)]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kw; ++w) {
      const float* sl = slots + (w * PT + pl) * (2 + DR);
      const float c = exp2f(sl[0] - M);
      L = fmaf(sl[1], c, L);
      A = fmaf(sl[2 + d], c, A);
    }
    float* mg = merged + pl * (2 + DR);
    mg[2 + d] = A;
    if (d == 0) {
      mg[0] = M;
      mg[1] = L;
    }
  }
  cluster.sync();  // every CTA's merged slots written, visible to rank 0
  if (rank == 0) {
    for (int e = threadIdx.x; e < PT * DR; e += nthr) {
      const int pl = e / DR, d = e % DR, p = pt0 + pl;
      if (p >= n_pairs) continue;
      const int i = p / G, g = p % G;
      T* dst = out + (((long long)b * Sq + i) * H + hk * G + g) * DR + d;
      if (qoff + i >= ctx) {  // bucket padding, or a ctx = 0 lane
        *dst = from_f32<T>(0.f);
        continue;
      }
      // the splits' (m, l, acc[d]), every load issued before any is used
      float mr[kPvMaxSplit], lr[kPvMaxSplit], ar[kPvMaxSplit];
#pragma unroll
      for (int r = 0; r < kPvMaxSplit; ++r) {
        mr[r] = kEmpty;
        lr[r] = ar[r] = 0.f;
        if (r < n_split) {
          const float* mg = cluster.map_shared_rank(merged, r) + pl * (2 + DR);
          mr[r] = mg[0];
          lr[r] = mg[1];
          ar[r] = mg[2 + d];
        }
      }
      float M = kEmpty;
#pragma unroll
      for (int r = 0; r < kPvMaxSplit; ++r) M = fmaxf(M, mr[r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int r = 0; r < kPvMaxSplit; ++r) {
        const float c = exp2f(mr[r] - M);
        L = fmaf(lr[r], c, L);
        A = fmaf(ar[r], c, A);
      }
      *dst = from_f32<T>(A / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();  // the other CTAs' slots stay until rank 0 has read them
}

// ---------------------------------------------------------------------------
// dispatch on (dtype, DR, quant)
// ---------------------------------------------------------------------------

struct Quant {
  const int8_t* kq;
  const int8_t* vq;
  const float* k_scales;
  const float* v_scales;
  const int* page_quant;
};

template <typename T, int DR, bool kQuant>
cudaError_t scores_t(const void* q, int qsb, int qss, int qsh,
                     const void* k_pages, const Quant& qa, const int* tables,
                     const int* q_offsets, const int* ctx_lens, float* scores,
                     int B, int Sq, int H, int Hkv, int page, int T_width,
                     int row_split, int accumulate, cudaStream_t s) {
  using R = Rows<T, DR>;
  const long long T_len = (long long)T_width * page;
  const long long tiles = (T_len + kTileKeys - 1) / kTileKeys;
  if (row_split < 1 || row_split > Sq) return cudaErrorInvalidValue;
  if (tiles > 0x7fffffffLL || (long long)B * Hkv > 65535 ||
      row_split > 65535)
    return cudaErrorInvalidConfiguration;
  const int qvec =
      reinterpret_cast<uintptr_t>(q) % R::kFpBytes == 0 &&
      qsb % R::kCE == 0 && qss % R::kCE == 0 && qsh % R::kCE == 0;
  const int vec =
      T_len % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B * Hkv),
                  static_cast<unsigned>(row_split));
  feature_scores<T, DR, kQuant><<<grid, kF1Warps * 32, 0, s>>>(
      static_cast<const T*>(q), qsb, qss, qsh, qvec,
      static_cast<const T*>(k_pages), qa.kq, qa.k_scales, qa.page_quant,
      tables, q_offsets, ctx_lens, scores, Sq, H, Hkv, page, T_width,
      accumulate, vec);
  return cudaGetLastError();
}

template <typename T, int DR, bool kQuant>
cudaError_t pv_t(const float* scores, const void* v_pages, const Quant& qa,
                 const int* tables, const int* q_offsets, const int* ctx_lens,
                 void* out, int B, int Sq, int H, int Hkv, int page,
                 int T_width, int npg, int kw, int n_split, int split,
                 float scale_log2, int device, cudaStream_t s) {
  using R = Rows<T, DR>;
  constexpr int NPW = Pv<DR>::kPairs;
  const long long T_len = (long long)T_width * page;
  // the geometry feature_pv_plan gives
  if (!(npg == 1 || npg == 2 || npg == 4 || npg == 8) || kw < 1 ||
      npg * kw > kPvMaxWarps || kTileKeys * kw * DR > kStageFloats ||
      n_split < 1 ||
      n_split > kPvMaxSplit || split < kTileKeys || split % kTileKeys ||
      (long long)split * n_split < T_len ||
      (long long)split * (n_split - 1) >= T_len)
    return cudaErrorInvalidValue;
  const int G = H / Hkv, PT = npg * NPW;
  const long long tiles = ((long long)Sq * G + PT - 1) / PT;
  if (tiles > 65535 || (long long)B * Hkv > 65535)
    return cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * (2 * DR * kTileKeys * kw + (kw + 1) * PT * (2 + DR)) +
      static_cast<size_t>(kRing) * kTileKeys * kw * DR * sizeof(T) +
      sizeof(float4) * npg * kw * kRing * NPW * 32 +
      (kQuant ? sizeof(float) * kRing * kTileKeys * kw * R::kChunks : 0);
  auto kern = feature_softmax_pv<T, DR, kQuant>;
  // the dynamic shared memory a block of this kernel may take, raised on a
  // device when a launch needs more than before (so not again inside the
  // graph capture of a call already made)
  static size_t raised[64] = {};
  size_t& got = raised[device & 63];
  if (smem > got) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    got = smem;
  }
  const int vec =
      T_len % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_split),
                     static_cast<unsigned>(tiles),
                     static_cast<unsigned>(B * Hkv));
  cfg.blockDim = dim3(static_cast<unsigned>(32 * npg * kw));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, scores, static_cast<const T*>(v_pages), qa.vq, qa.v_scales,
      qa.page_quant, tables, q_offsets, ctx_lens, static_cast<T*>(out), Sq, H,
      Hkv, page, T_width, scale_log2, npg, kw, split, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// F(T, DR, kQuant) for the runtime (dtype, dr, quant); DR in 2..64, powers
// of two
#define FEATURE_DISPATCH(F, ...)                                             \
  switch (dr) {                                                              \
    case 2: return quant ? F<T, 2, true>(__VA_ARGS__)                        \
                         : F<T, 2, false>(__VA_ARGS__);                      \
    case 4: return quant ? F<T, 4, true>(__VA_ARGS__)                        \
                         : F<T, 4, false>(__VA_ARGS__);                      \
    case 8: return quant ? F<T, 8, true>(__VA_ARGS__)                        \
                         : F<T, 8, false>(__VA_ARGS__);                      \
    case 16: return quant ? F<T, 16, true>(__VA_ARGS__)                      \
                          : F<T, 16, false>(__VA_ARGS__);                    \
    case 32: return quant ? F<T, 32, true>(__VA_ARGS__)                      \
                          : F<T, 32, false>(__VA_ARGS__);                    \
    case 64: return quant ? F<T, 64, true>(__VA_ARGS__)                      \
                          : F<T, 64, false>(__VA_ARGS__);                    \
    default: return cudaErrorInvalidValue;                                   \
  }

template <typename T>
cudaError_t scores_dr(int dr, bool quant, const void* q, int qsb, int qss,
                      int qsh, const void* k_pages, const Quant& qa,
                      const int* tables, const int* q_offsets,
                      const int* ctx_lens, float* scores, int B, int Sq, int H,
                      int Hkv, int page, int T_width, int row_split,
                      int accumulate, cudaStream_t s) {
  FEATURE_DISPATCH(scores_t, q, qsb, qss, qsh, k_pages, qa, tables, q_offsets,
                   ctx_lens, scores, B, Sq, H, Hkv, page, T_width, row_split,
                   accumulate, s)
}

template <typename T>
cudaError_t pv_dr(int dr, bool quant, const float* scores,
                  const void* v_pages, const Quant& qa, const int* tables,
                  const int* q_offsets, const int* ctx_lens, void* out, int B,
                  int Sq, int H, int Hkv, int page, int T_width, int npg,
                  int kw, int n_split, int split, float scale_log2,
                  int device, cudaStream_t s) {
  FEATURE_DISPATCH(pv_t, scores, v_pages, qa, tables, q_offsets, ctx_lens,
                   out, B, Sq, H, Hkv, page, T_width, npg, kw, n_split, split,
                   scale_log2, device, s)
}

// pages of 1 to 32 rows, powers of two: a 128-key tile starts on a page
bool shape_ok(int B, int Sq, int H, int Hkv, int page, int T_width,
              int dtype) {
  return B > 0 && Sq > 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= 16 &&
         page > 0 && page <= 32 && (page & (page - 1)) == 0 && T_width > 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// F1.  q (B, Sq, H, dr) at element strides (qsb, qss, qsh) and 1 along dr;
// k_pages (P, page, Hkv, dr); the int8 pointers (kq_pages (P, page, Hkv,
// dr), k_scales (P,), page_quant (P,)) null for kernel 1's mode; tables (B,
// T_width), q_offsets and ctx_lens (B,) int32; scores (B, H, Sq, T_width *
// page) float32, written (accumulate 0) or added to (1) where a row sees the
// key; row_split (paged_attention.feature_scores_plan) the parts a key
// tile's rows are cut into, one CTA each.  dtype 0 float32, 1 bfloat16.
extern "C" int paged_chunk_scores_launch(
    const void* q, const void* k_pages, const void* kq_pages,
    const float* k_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, float* scores, int qsb,
    int qss, int qsh, int B, int Sq, int H, int Hkv, int dr, int page,
    int T_width, int row_split, int accumulate, int dtype, int device,
    void* stream) {
  if (!shape_ok(B, Sq, H, Hkv, page, T_width, dtype))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Quant qa = {static_cast<const int8_t*>(kq_pages), nullptr, k_scales,
                    nullptr, page_quant};
  const bool quant = page_quant != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return scores_dr<float>(dr, quant, q, qsb, qss, qsh, k_pages, qa, tables,
                            q_offsets, ctx_lens, scores, B, Sq, H, Hkv, page,
                            T_width, row_split, accumulate, s);
  return scores_dr<__nv_bfloat16>(dr, quant, q, qsb, qss, qsh, k_pages, qa,
                                  tables, q_offsets, ctx_lens, scores, B, Sq,
                                  H, Hkv, page, T_width, row_split, accumulate,
                                  s);
}

// F2.  scores (B, H, Sq, T_width * page) float32, summed over the shards;
// v_pages (P, page, Hkv, dr); the int8 pointers (vq_pages, v_scales,
// page_quant) null for kernel 1's mode; out (B, Sq, H, dr) in V's dtype;
// (npg, kw, n_split, split) the launch geometry of
// paged_attention.feature_pv_plan: npg pair groups and kw key warps a CTA,
// the keys cut into n_split splits of `split` keys over the CTAs of one
// cluster; scale_log2 = log2(e) / sqrt(D) of the full head.
extern "C" int paged_chunk_softmax_pv_launch(
    const float* scores, const void* v_pages, const void* vq_pages,
    const float* v_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, void* out, int B, int Sq,
    int H, int Hkv, int dr, int page, int T_width, int npg, int kw,
    int n_split, int split, float scale_log2, int dtype, int device,
    void* stream) {
  if (!shape_ok(B, Sq, H, Hkv, page, T_width, dtype))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Quant qa = {nullptr, static_cast<const int8_t*>(vq_pages), nullptr,
                    v_scales, page_quant};
  const bool quant = page_quant != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pv_dr<float>(dr, quant, scores, v_pages, qa, tables, q_offsets,
                        ctx_lens, out, B, Sq, H, Hkv, page, T_width, npg, kw,
                        n_split, split, scale_log2, device, s);
  return pv_dr<__nv_bfloat16>(dr, quant, scores, v_pages, qa, tables,
                              q_offsets, ctx_lens, out, B, Sq, H, Hkv, page,
                              T_width, npg, kw, n_split, split, scale_log2,
                              device, s);
}
