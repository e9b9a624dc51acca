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
// Design.  One CTA of 256 threads owns one (lane, kv head, query block).  Its
// tile holds kRows = 64 rows: the G heads of bq = 64 / G query positions, as
// the TPU kernel's bq * G rows (16 positions x 4 heads for llama3-8b).  It
// walks the block's keys kKeys = 64 at a time and only up to the causal
// horizon of its last real position, q_offset + min(q0 + bq, Sq) - 1: tiles
// wholly after it are neither loaded nor computed.  K/V tiles come from
// contiguous rows with 16-byte loads, one tile ahead into registers, so the
// next tile's loads are in flight while this one computes; they are staged
// in shared memory as float32.  Each thread owns 4 rows x 4 keys of the
// 64 x 64 score tile (rows tr + 16 i, keys tc + 16 j with tr = tid / 16,
// tc = tid % 16), so 8 float4 loads from shared memory feed 64 FMAs; the
// 16 threads of a row are one half-warp, which reduces the row's max and sum
// with shuffles.  The same thread owns the same 4 rows of the P.V
// accumulator (4 rows x D / 16 columns in registers), so the online
// softmax's rescale stays in registers; only P goes through shared memory.
// Blocks are issued longest first (the last query block sees the most keys).
//
// What bounds it.  Prefill attention does 4 * D operations per (query head,
// visible key) pair and reads each K/V row once per kv head: at the dense
// reference's lengths (hundreds to thousands of tokens) it is bound by
// operations on the card (Sq * G / 4 operations per K/V byte in bf16, far
// above the ~295 at which bf16 tensor cores stop waiting for memory).  This
// first version runs its products on the CUDA cores in float32 (no
// mma/wgmma, no TMA ring) at one CTA per SM (121 KB of shared memory at
// D = 128), so it sits far from that bound; K/V re-reads across the query
// blocks of a lane come mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 16 bytes of T widened to float32 in smem (4 floats for float, 8 for bf16)
__device__ __forceinline__ void widen(const uint4& u, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
}
__device__ __forceinline__ void widen(const uint4& u, float* dst,
                                      __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
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

template <int D>
constexpr size_t smem_bytes() {
  // q_s [kRows][D + 4], k_s [kKeys][D + 4], v_s [kKeys][D], p_s [kRows][kPStride]
  return sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)kKeys * (D + 4) +
                          (size_t)kKeys * D + (size_t)kRows * kPStride);
}

// q (B, Sq, H, D); k, v (B, Skv, Hkv, D); out (B, Sq, H, D).  All
// contiguous and 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int H, int Hkv, int q_offset, int bq) {
  constexpr int kQs = D + 4;               // +4: conflict-free float4 rows
  constexpr int kPerVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kRowVecs = D / kPerVec;    // 16-byte vectors per K/V row
  constexpr int kLd = kKeys * kRowVecs / kThreads;  // vectors per thread
  constexpr int kCol4 = D / (4 * kTile);   // float4 accumulators per row
  static_assert(D % (4 * kTile) == 0, "head dim must be a multiple of 64");
  static_assert(kKeys * kRowVecs % kThreads == 0, "whole loads per thread");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                           // [kRows][kQs]
  float* k_s = q_s + kRows * kQs;              // [kKeys][kQs]
  float* v_s = k_s + kKeys * kQs;              // [kKeys][D]
  float* p_s = v_s + kKeys * D;                // [kRows][kPStride]

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
      widen(v_reg[n], v_s + j * D + vi * kPerVec, T());
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
        const float* vrow = v_s + (j + jj) * D;
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

// dtype: 0 = float32, 1 = bfloat16; head dim 64 or 128; H % Hkv == 0 with
// H / Hkv <= 64; Skv >= q_offset + Sq.  Returns a cudaError_t (0 = launched).
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
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                     q_offset, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Skv, H, Hkv,
                                      q_offset, s);
  return cudaErrorInvalidValue;
}
