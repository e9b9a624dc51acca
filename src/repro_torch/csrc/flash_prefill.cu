// Causal prefill attention over dense K/V with a cached prefix, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_prefill` in src/repro/kernels/flash_prefill.py
// (body `_kernel`).  What it computes: q (B, Sq, H, D), k and v (B, Skv, Hkv,
// D) with Skv >= q_offset + Sq; query row i of lane b sits at absolute
// position q_offset + i and attends to key j iff q_offset + i >= j, with the
// softmax scaled by 1/sqrt(D) and an online (m, l, acc) in float32; the
// output is acc / max(l, 1e-30) in q's dtype.  GQA: the G = H / Hkv query
// heads of one kv head share its K/V.  Any Sq and Skv: the ragged edges are
// masked (the TPU kernel asks Sq to be a multiple of its query block), and
// keys past q_offset + Sq (padding) lie in every row's masked future.
//
// What bounds it.  Prefill attention does 4 * D operations per (query head,
// visible key) pair and reads each K/V row once per kv head: at the dense
// reference's lengths (hundreds to thousands of tokens) it is bound by
// operations on the card (Sq * G / 4 operations per K/V byte in bf16, far
// above the ~295 at which bf16 tensor cores stop waiting for memory).  So the
// remedy is the tensor cores, and there are two bodies, one per dtype, behind
// one launch function.
//
// bfloat16: the tensor-core body (flash_prefill_tc).  One CTA owns one
// (lane, kv head, query block) tile of kTcRows = 64 query rows: the G heads
// of bq = 64 / G positions, row r = position q0 + r / G, head h * G + r % G,
// as the TPU kernel packs bq * G rows, so every K/V tile is loaded once for
// the whole group.  One producer warp streams the tile's keys, kTcKeys = 64
// at a time, into a ring of kTcStages = 2 shared-memory stages by TMA
// (cp.async.bulk.tensor over a (B, q_offset + Sq, Hkv * D) view of K and of
// V, 128-byte swizzle, one 64-column box per 128 bytes of a row; rows past
// q_offset + Sq come back as zeros, so no garbage ever meets a p of 0), with
// a full and an empty mbarrier per stage.  One consumer warpgroup runs
// S = Q.K^T as wgmma m64nKk16 (Q and K K-major in swizzled shared memory),
// the online softmax on S's accumulator fragments in registers (exp2 of
// pre-scaled scores; row max by quad shuffles; O rescaled in registers),
// converts P to bf16 A fragments in registers and runs O += P.V as wgmma
// m64nDk16 with P from registers and V's [keys][D] tile read as the
// transposed (MN-major) B operand.  P never touches shared memory.  Only
// tiles that reach past the first row's horizon are masked; tiles past the
// last real row's horizon are neither loaded nor computed.  160 threads and
// 83 KB of shared memory at D = 128 leave two CTAs resident per SM, so one
// CTA's softmax overlaps the other's products.  Blocks are issued longest
// first across all lanes and heads.
//   * Where G does not divide 64 (granite-moe's G = 3: bq = 21 positions,
//     63 rows), the rows past bq * G are zero Q rows whose horizon is -1:
//     masked in every tile, never written.  That keeps one tile shape and
//     one row map for every G (a row count that is a multiple of G would
//     need another wgmma M, which is 64 only) at the cost of 1 / 64 of the
//     tile's products.
//   * D = 96 (phi-3-vision): a row takes two 64-column blocks, as at D =
//     128; the second box of a row reads the next head's first 32 columns
//     (zeros past the last head), which no product reads: Q.K^T takes 6
//     k16 steps and P.V is m64n96k16, so neither reaches a column past 96.
//     The staged Q rows are zero past 96.
// The tile constants below were chosen by kernels/flash_tiles.py's times on
// the card at the dense reference's shapes (PERF.md).
//
// float32: the CUDA-core body (flash_prefill_kernel).  The H100 has no
// float32 tensor-core product other than TF32 (about three decimal digits),
// and the fp32 paths are held to exact tokens, so this body keeps its
// float32 FMAs: one CTA of 256 threads per 64-row tile, 64 keys a step
// staged in shared memory (16-byte loads one tile ahead), each thread 4
// rows x 4 keys of the score tile and the same 4 rows of the accumulator,
// P through shared memory.  121 KB of shared memory at D = 128, one CTA per
// SM; it sits far from the operations bound.  At D = 96 the P.V accumulators
// cover 128 columns, of which the 32 pad columns read zeros and are never
// written; the scores and the loads take D's own 96.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // query rows (positions x heads) a CTA
constexpr int kKeys = 64;               // keys staged per step
constexpr int kTile = 16;               // threads along a row / along keys
constexpr int kRpt = kRows / kTile;     // rows a thread owns (4)
constexpr int kKpt = kKeys / kTile;     // keys a thread owns per step (4)
constexpr int kPStride = kKeys + 16;    // p_s row: two half-warps, other banks
constexpr float kMaskValue = -1e30f;    // the TPU kernel's mask value

static_assert(kThreads == kTile * kTile, "one thread per (row, key) group");

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// 16 bytes of T staged in smem as float32
__device__ __forceinline__ void widen(const uint4& u, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
}

// max / sum over the 16 lanes of a half-warp (one score row's threads)
__device__ __forceinline__ float row_max(float x) {
  for (int o = kTile / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = kTile / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// P.V columns a thread row covers: D rounded up to 4 * kTile (D = 96 ->
// 128); the pad columns of v_s are zeros and are never written out
template <int D>
__host__ __device__ constexpr int pv_cols() {
  return (D + 4 * kTile - 1) / (4 * kTile) * (4 * kTile);
}

template <int D>
constexpr size_t smem_bytes() {
  // q_s [kRows][D + 4], k_s [kKeys][D + 4], v_s [kKeys][kDp],
  // p_s [kRows][kPStride]
  return sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)kKeys * (D + 4) +
                          (size_t)kKeys * pv_cols<D>() +
                          (size_t)kRows * kPStride);
}

// q (B, Sq, H, D); k, v (B, Skv, Hkv, D); out (B, Sq, H, D).  All
// contiguous and 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int H, int Hkv, int q_offset, int bq) {
  constexpr int kQs = D + 4;               // +4: conflict-free float4 rows
  constexpr int kDp = pv_cols<D>();        // v_s row: D and its pad columns
  constexpr int kPerVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kRowVecs = D / kPerVec;    // 16-byte vectors per K/V row
  constexpr int kLd = kKeys * kRowVecs / kThreads;  // vectors per thread
  constexpr int kCol4 = kDp / (4 * kTile); // float4 accumulators per row
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  static_assert(kKeys * kRowVecs % kThreads == 0, "whole loads per thread");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                           // [kRows][kQs]
  float* k_s = q_s + kRows * kQs;              // [kKeys][kQs]
  float* v_s = k_s + kKeys * kQs;              // [kKeys][kDp]
  float* p_s = v_s + kKeys * kDp;              // [kRows][kPStride]

  const int G = H / Hkv;
  const int rows = bq * G;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi_blk = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int q0 = qi_blk * bq;
  const int tid = threadIdx.x;
  const int tr = tid / kTile;
  const int tc = tid % kTile;

  const int q_last = min(q0 + bq, Sq) - 1;
  // keys this block sees: up to its last real position's horizon
  const int kv_end = min(Skv, q_offset + q_last + 1);

  // stage the block's queries as float32 rows (zeros past Sq or `rows`)
  for (int i = tid; i < kRows * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, vi = i % kRowVecs;
    const int qi = q0 + r / G;
    float* dst = q_s + r * kQs + vi * kPerVec;
    if (r < rows && qi < Sq) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + qi) * H + h * G + r % G) * D) + vi);
      widen(u, dst, T());
    } else {
#pragma unroll
      for (int e = 0; e < kPerVec; ++e) dst[e] = 0.f;
    }
  }

  if constexpr (kDp > D) {  // the pad columns, read by P.V, stay zero
    for (int i = tid; i < kKeys * (kDp - D); i += kThreads)
      v_s[(i / (kDp - D)) * kDp + D + i % (kDp - D)] = 0.f;
  }

  // loader role: thread tid stages vectors tid + n * kThreads of the tile
  uint4 k_reg[kLd], v_reg[kLd];
  const size_t row_stride = (size_t)Hkv * D;
  const T* k_base = k + ((size_t)b * Skv * Hkv + h) * D;
  const T* v_base = v + ((size_t)b * Skv * Hkv + h) * D;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int n = 0; n < kLd; ++n) {
      const int e = tid + n * kThreads;
      const int kpos = k0 + e / kRowVecs;
      const int vi = e % kRowVecs;
      if (kpos < kv_end) {
        k_reg[n] = __ldg(reinterpret_cast<const uint4*>(
                             k_base + (size_t)kpos * row_stride) + vi);
        v_reg[n] = __ldg(reinterpret_cast<const uint4*>(
                             v_base + (size_t)kpos * row_stride) + vi);
      } else {  // zeros, never garbage: p = 0 times v
        k_reg[n] = make_uint4(0, 0, 0, 0);
        v_reg[n] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float m[kRpt], l[kRpt];
  float4 acc[kRpt][kCol4];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCol4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the absolute position of each owned row (rows past `rows` or Sq see
  // nothing: their horizon is -1)
  int qpos[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = tr + kTile * i;
    const int qi = q0 + r / G;
    qpos[i] = (r < rows && qi < Sq) ? q_offset + qi : -1;
  }
  const float scale = 1.f / sqrtf((float)D);

  if (kv_end > 0) fetch(0);
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
#pragma unroll
    for (int n = 0; n < kLd; ++n) {
      const int e = tid + n * kThreads;
      const int j = e / kRowVecs, vi = e % kRowVecs;
      widen(k_reg[n], k_s + j * kQs + vi * kPerVec, T());
      widen(v_reg[n], v_s + j * kDp + vi * kPerVec, T());
    }
    __syncthreads();
    if (k0 + kKeys < kv_end) fetch(k0 + kKeys);  // in flight during the math

    // scores: rows tr + 16 i, keys tc + 16 j
    float s[kRpt][kKpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kKpt; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[kRpt], ka[kKpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (tr + kTile * i) * kQs + d);
#pragma unroll
      for (int j = 0; j < kKpt; ++j)
        ka[j] = *reinterpret_cast<const float4*>(k_s + (tc + kTile * j) * kQs + d);
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < kKpt; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // online softmax, per owned row; the row's 16 threads agree on m and l
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      float smax = kMaskValue;
      bool valid[kKpt];
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const int kpos = k0 + tc + kTile * j;
        valid[j] = kpos < kv_end && kpos <= qpos[i];
        s[i][j] = valid[j] ? s[i][j] * scale : kMaskValue;
        smax = fmaxf(smax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(smax));
      float psum = 0.f;
      float* prow = p_s + (tr + kTile * i) * kPStride;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        prow[tc + kTile * j] = p;
      }
      const float c = expf(m[i] - m_new);
      l[i] = l[i] * c + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCol4; ++cc) {
        acc[i][cc].x *= c; acc[i][cc].y *= c;
        acc[i][cc].z *= c; acc[i][cc].w *= c;
      }
    }
    __syncthreads();  // p_s is complete

    // P.V: rows tr + 16 i, columns 4 (tc + 16 cc) .. + 3
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 p4[kRpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_s + (tr + kTile * i) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = v_s + (j + jj) * kDp;
#pragma unroll
        for (int cc = 0; cc < kCol4; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vrow + 4 * (tc + kTile * cc));
#pragma unroll
          for (int i = 0; i < kRpt; ++i) {
            const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z : p4[i].w;
            acc[i][cc].x = fmaf(p, vv.x, acc[i][cc].x);
            acc[i][cc].y = fmaf(p, vv.y, acc[i][cc].y);
            acc[i][cc].z = fmaf(p, vv.z, acc[i][cc].z);
            acc[i][cc].w = fmaf(p, vv.w, acc[i][cc].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = tr + kTile * i;
    const int qi = q0 + r / G;
    if (r >= rows || qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h * G + r % G) * D;
#pragma unroll
    for (int cc = 0; cc < kCol4; ++cc) {
      const int col = 4 * (tc + kTile * cc);
      if (kDp > D && col >= D) continue;   // a pad column
      o[col + 0] = from_f32<T>(acc[i][cc].x / denom);
      o[col + 1] = from_f32<T>(acc[i][cc].y / denom);
      o[col + 2] = from_f32<T>(acc[i][cc].z / denom);
      o[col + 3] = from_f32<T>(acc[i][cc].w / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int q_offset,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const int bq = kRows / G;
  const dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv,
      q_offset, bq);
  return cudaGetLastError();
}


}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body
// ---------------------------------------------------------------------------

namespace {

constexpr int kTcRows = 64;                    // query rows a CTA
constexpr int kTcKeys = 64;                    // keys a ring stage
constexpr int kTcStages = 2;                   // ring stages
constexpr int kTcCtasPerSm = 2;                // __launch_bounds__ minimum
constexpr int kTcThreads = 128 + 32;           // a consumer warpgroup and a
                                               // producer warp

static_assert(kTcKeys % 16 == 0 && kTcKeys <= 256, "wgmma N and K steps");

// Byte offsets in the 1024-byte-aligned dynamic shared memory.  Each tile is
// stored as kCb = ceil(D / 64) column blocks of [rows][128 bytes], 128-byte
// swizzled: the 16-byte chunk c of row r sits at chunk c ^ (r % 8), as TMA
// writes it and as wgmma's SWIZZLE_128B descriptors read it.
template <int D>
struct TcSmem {
  static constexpr int kCb = (D + 63) / 64;                // column blocks
  static constexpr int kQ = 0;
  static constexpr int kStage = kTcKeys * kCb * 128;       // one K or V tile
  static constexpr int kK = kTcRows * kCb * 128;
  static constexpr int kV = kK + kTcStages * kStage;
  static constexpr int kBars = kV + kTcStages * kStage;    // full, empty
  static constexpr int kBytes = kBars + 2 * kTcStages * 8;
  static constexpr int kAlloc = kBytes + 1024;             // alignment slack
};

// q, out (B, Sq, H, D) bf16, contiguous; K and V through their tensor maps
// over (B, q_offset + Sq, Hkv * D).  Grid: one CTA per (query block, kv
// head, lane), the longest query blocks first.
template <int D>
__global__ void __launch_bounds__(kTcThreads, kTcCtasPerSm)
flash_prefill_tc(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q,
                 __nv_bfloat16* __restrict__ out, int B, int Sq, int H,
                 int Hkv, int q_offset, int bq, int n_qblk) {
  using L = TcSmem<D>;
  constexpr int kCb = L::kCb;                 // 128-byte column blocks a row
  constexpr int kChunks = D / 8;              // 16-byte chunks a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + L::kBars;     // full[s], then empty[s]
  const uint32_t empty0 = full0 + 8 * kTcStages;

  const int G = H / Hkv;
  const int rows = bq * G;
  const int hb = blockIdx.x % (Hkv * B);
  const int h = hb % Hkv, b = hb / Hkv;
  const int q0 = (n_qblk - 1 - blockIdx.x / (Hkv * B)) * bq;
  const int q_last = min(q0 + bq, Sq) - 1;
  // keys the block sees: up to its last real position's horizon
  const int kv_end = q_offset + q_last + 1;
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kTcStages;
        if (t >= kTcStages) mbar_wait(empty0 + 8 * s, (t / kTcStages - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::kStage);
#pragma unroll
        for (int c = 0; c < kCb; ++c) {
          const uint32_t off = s * L::kStage + c * kTcKeys * 128;
          tma_load_3d(base + L::kK + off, &kmap, full0 + 8 * s, h * D + 64 * c,
                      t * kTcKeys, b);
          tma_load_3d(base + L::kV + off, &vmap, full0 + 8 * s, h * D + 64 * c,
                      t * kTcKeys, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: stage the block's query rows, swizzled (zeros
  // past `rows` or Sq, and past D), then make the generic-proxy stores
  // visible to wgmma
  for (int i = threadIdx.x; i < kTcRows * kCb * 8; i += 128) {
    const int r = i / (kCb * 8), c = i % (kCb * 8);
    const int qi = q0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < kChunks && r < rows && qi < Sq)
      val = __ldg(reinterpret_cast<const uint4*>(
                q + (((size_t)b * Sq + qi) * H + h * G + r % G) * D) + c);
    *reinterpret_cast<uint4*>(smem + L::kQ + (c / 8) * kTcRows * 128 +
                              r * 128 + (((c % 8) ^ (r % 8)) * 16)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  const int g = lane / 4, tq = lane % 4;       // row group, thread in quad
  const int r0 = warp * 16 + g;                // rows r0 and r0 + 8
  int qpos[2];                                 // -1: a row past `rows` or Sq
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 8 * j;
    qpos[j] = (r < rows && q0 + r / G < Sq) ? q_offset + q0 + r / G : -1;
  }
  const int first = q_offset + q0;             // row 0's horizon; row 0 is real

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e)/sqrt(D)

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kTcStages;
    const int k0 = t * kTcKeys;
    mbar_wait(full0 + 8 * s, (t / kTcStages) & 1);
    // S = Q.K^T on the tensor cores: D / 16 steps of k16
    float sc[kTcKeys / 2];
    const uint32_t k_tile = base + L::kK + s * L::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sw128_desc(
          base + L::kQ + (kk / 4) * kTcRows * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = sw128_desc(
          k_tile + (kk / 4) * kTcKeys * 128 + (kk % 4) * 32, 16, 1024);
      Wgmma::ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragments: sc[4 i + e] is row r0 + 8 (e / 2),
    // key k0 + 8 i + 2 tq + e % 2; a row's keys span the 4 threads of a quad
    const bool masked = k0 + kTcKeys - 1 > first;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * sl2;
        if (masked && k0 + 8 * i + 2 * tq + (e & 1) > qpos[e / 2])
          x = __int_as_float(0xff800000);  // -inf: p = 0
        sc[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      corr[j] = exp2f(m[j] - mx[j]);  // m, mx >= the finite mask value
      m[j] = mx[j];
      l[j] *= corr[j];
    }
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * i + e] - m[e / 2]);  // masked: 0
        sc[4 * i + e] = p;
        l[e / 2] += p;  // this thread's keys; the quad sums at the end
      }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i + 0] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // P as bf16 A fragments: keys 16 kt .. 16 kt + 15 are S's column
    // blocks 2 kt and 2 kt + 1
    uint32_t pa[kTcKeys / 16][4];
#pragma unroll
    for (int kt = 0; kt < kTcKeys / 16; ++kt) {
      pa[kt][0] = pack_bf16(sc[8 * kt + 0], sc[8 * kt + 1]);
      pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
      pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
      pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
    }

    // O += P.V: V's [keys][D] tile is the MN-major B operand; its 64-column
    // blocks lie kTcKeys * 128 bytes apart (LBO), 8-key groups 1024 (SBO)
    const uint32_t v_tile = base + L::kV + s * L::kStage;
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kTcKeys / 16; ++kt)
      Wgmma::rs(o, pa[kt], sw128_desc(v_tile + kt * 16 * 128,
                                      kTcKeys * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with s
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (qpos[j] < 0) continue;
    const int r = r0 + 8 * j;
    const float denom = fmaxf(l[j], 1e-30f);
    __nv_bfloat16* dst =
        out + (((size_t)b * Sq + q0 + r / G) * H + h * G + r % G) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * tq) =
          __floats2bfloat162_rn(o[4 * i + 2 * j] / denom,
                                o[4 * i + 2 * j + 1] / denom);
  }
}

// K or V (B, Skv, Hkv, D) seen as (B, keys, Hkv * D) with keys = q_offset +
// Sq: boxes of 64 columns x kTcKeys keys, zeros past the last key
bool kv_map(CUtensorMap* map, const void* base, int B, int keys, int Skv,
            int Hkv, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Hkv * D, (cuuint64_t)keys,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Skv * Hkv * D * 2};
  const cuuint32_t box[3] = {64, kTcKeys, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int Hkv, int q_offset,
                      cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, B, q_offset + Sq, Skv, Hkv, D) ||
      !kv_map(&vmap, v, B, q_offset + Sq, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int bq = kTcRows / G;
  const int n_qblk = (Sq + bq - 1) / bq;
  const long long n_ctas = (long long)n_qblk * Hkv * B;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = TcSmem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_prefill_tc<D><<<(unsigned)n_ctas, kTcThreads, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), B, Sq, H, Hkv, q_offset, bq, n_qblk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body); head dim 64, 96 or 128; H % Hkv == 0 with H / Hkv <= 64; Skv >=
// q_offset + Sq.  Returns a cudaError_t (0 = launched).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Skv, int H, int Hkv, int D,
                                    int q_offset, int dtype, int device,
                                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kRows) return cudaErrorInvalidValue;
  if (B > 65535 || Hkv > 65535 || q_offset < 0 || Skv < q_offset + Sq)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 0 && D == 96)
    return launch<float, 96>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 1 && D == 96)
    return launch_tc<96>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  return cudaErrorInvalidValue;
}

// out[5]: the `resources` of the body that flash_prefill_launch runs for
// (dtype, D).  Returns a cudaError_t.
extern "C" int flash_prefill_resources(int D, int dtype, int device,
                                       int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0 && D == 64)
    return resources(flash_prefill_kernel<float, 64>, kThreads,
                     (int)smem_bytes<64>(), out);
  if (dtype == 0 && D == 96)
    return resources(flash_prefill_kernel<float, 96>, kThreads,
                     (int)smem_bytes<96>(), out);
  if (dtype == 0 && D == 128)
    return resources(flash_prefill_kernel<float, 128>, kThreads,
                     (int)smem_bytes<128>(), out);
  if (dtype == 1 && D == 64)
    return resources(flash_prefill_tc<64>, kTcThreads, TcSmem<64>::kAlloc,
                     out);
  if (dtype == 1 && D == 96)
    return resources(flash_prefill_tc<96>, kTcThreads, TcSmem<96>::kAlloc,
                     out);
  if (dtype == 1 && D == 128)
    return resources(flash_prefill_tc<128>, kTcThreads, TcSmem<128>::kAlloc,
                     out);
  return cudaErrorInvalidValue;
}
