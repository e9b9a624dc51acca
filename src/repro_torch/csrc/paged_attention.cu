// Single-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// paged_attention_launch replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`, index map
// `kv_index`).  What it computes: lane b's G = H / Hkv query heads of kv
// head h attend, with a float32 online softmax (m, l, acc), to the keys at
// positions < ctx_lens[b], read through row b of the block table.  Only the
// lane's first ceil(ctx / page) table columns are read, whatever the columns
// past them hold (callers repeat the last valid page id).  A lane with
// ctx = 0 writes zeros and reads no K/V (the TPU kernel's page walk skips
// every page and divides an empty accumulator by max(l, 1e-30)).  Keys past
// the table's width are never seen, as on the TPU, whose grid walks exactly
// the table's columns.
//
// Design.  One CTA of 128 threads owns one (lane, kv head): the TPU grid's
// (B, Hkv) axes become the CUDA grid, and its sequential page axis, whose
// index map re-maps every page past the lane's last relevant one to that
// page so Pallas elides the copies, becomes a loop inside the CTA over the
// relevant keys only, 32 keys a step.  The CTA reads its own lane's ctx and
// table row (there is no scalar prefetch).  The G query rows sit in shared
// memory as float32.  Four threads load each key's K and V rows with
// 16-byte loads (one table lookup each), one step ahead into registers, so
// the next step's loads are in flight while this step computes; the rows
// are staged in shared memory as float32; each thread scores one (head,
// key) pair of the G x 32 tile, one warp per head runs the online softmax
// update, and each thread accumulates its float4 columns of P.V in
// registers (G x D / 4 float4 outputs over 128 threads).
//
// What bounds it.  Decode is bound by bytes: every relevant K/V row is read
// once, and each of its 2 D bytes-per-element pairs does G multiply-adds per
// head in QK and G in PV, so the operations per byte are G / 2 (bf16) or
// G / 4 (float32), far below the card's ~295 bf16 operations per byte.
//
// What this simple version leaves on the table: there is no split-KV, so a
// decode batch gives only B x Hkv CTAs (64 at B = 8 for llama3-8b) on 132
// SMs, each walking its lane's whole context alone; the load pipeline is
// one step deep through registers (no cp.async or TMA ring); at G = 1 most
// threads idle in the softmax and P.V phases.
//
// Head dims 32, 64, 80 and 128; pages of 8, 16 and 32; G from 1 to 16;
// float32 and bfloat16.  The host wrapper checks these before it launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;              // query heads per kv head
constexpr int kKeys = 32;              // keys staged per step: one per lane
constexpr int kSeg = kThreads / kKeys; // threads loading one key's row
constexpr float kMaskValue = -1e30f;   // the TPU kernel's mask value

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// q (B, H, D); k/v pages (P, page, Hkv, D); tables (B, T) int32; ctx_lens
// (B,) int32; out (B, H, D).  All contiguous, the pools 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ ctx_lens, T* __restrict__ out,
                       int H, int Hkv, int page, int T_width) {
  constexpr int kPerVec = 16 / sizeof(T);  // elements per 16-byte load
  // a key row is kRowVecs 16-byte vectors; loader seg takes vectors
  // [seg * kVecs, seg * kVecs + kVecs) of them, the last loader fewer where
  // kSeg does not divide the row (D = 80 in bf16)
  constexpr int kRowVecs = D * (int)sizeof(T) / 16;
  constexpr int kVecs = (kRowVecs + kSeg - 1) / kSeg;
  constexpr int kCol4 = D / 4;             // float4 columns of an output row
  // float4 outputs a thread owns at most (G = 16)
  constexpr int kOut = (kMaxG * kCol4 + kThreads - 1) / kThreads;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) float q_s[kMaxG][D];
  __shared__ __align__(16) float k_s[kKeys][D + 4];  // +4: conflict-free
  __shared__ __align__(16) float v_s[kKeys][D];
  __shared__ float p_s[kMaxG][kKeys + 1];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int G = H / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * D;

  const int ctx = ctx_lens[b];
  if (ctx <= 0) {  // an empty lane: zeros, no K/V read
    for (int i = tid; i < G * D; i += kThreads) out[row0 + i] = from_f32<T>(0.f);
    return;
  }
  // the lane's relevant keys: its context, never past the table
  const int kv_end = min(ctx, T_width * page);

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i / D][i % D] = to_f32(q[row0 + i]);
  if (tid < kMaxG) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }

  // loader role: thread tid stages its vectors of key ld_j of every step,
  // prefetched into registers one step ahead
  const int ld_j = tid / kSeg;
  const int seg = tid % kSeg;
  const int* table = tables + (size_t)b * T_width;
  uint4 k_reg[kVecs], v_reg[kVecs];
  auto fetch = [&](int k0) {
    const int kpos = k0 + ld_j;
    if (kpos < kv_end) {
      const size_t pid = (size_t)table[kpos / page];
      const size_t off = ((pid * page + kpos % page) * Hkv + h) * D;
      const uint4* ks = reinterpret_cast<const uint4*>(k_pages + off);
      const uint4* vs = reinterpret_cast<const uint4*>(v_pages + off);
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int vi = seg * kVecs + v;
        if (kRowVecs % kSeg == 0 || vi < kRowVecs) {
          k_reg[v] = __ldg(ks + vi);
          v_reg[v] = __ldg(vs + vi);
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {  // zeros, never garbage: p = 0 * v
        k_reg[v] = make_uint4(0, 0, 0, 0);
        v_reg[v] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float4 acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float scale = 1.f / sqrtf((float)D);

  fetch(0);
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int vi = seg * kVecs + v;
      if (kRowVecs % kSeg == 0 || vi < kRowVecs) {
        widen(k_reg[v], &k_s[ld_j][vi * kPerVec], T());
        widen(v_reg[v], &v_s[ld_j][vi * kPerVec], T());
      }
    }
    __syncthreads();
    if (k0 + kKeys < kv_end) fetch(k0 + kKeys);  // in flight during the math
    // scores: a warp takes one head (kKeys == 32), a lane one key
    for (int i = tid; i < G * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i % kKeys;
      float s = kMaskValue;
      if (k0 + j < kv_end) {
        const float4* qa = reinterpret_cast<const float4*>(q_s[r]);
        const float4* ka = reinterpret_cast<const float4*>(k_s[j]);
        float dot = 0.f;
#pragma unroll 8
        for (int d4 = 0; d4 < D / 4; ++d4) dot = dot4(qa[d4], ka[d4], dot);
        s = dot * scale;
      }
      p_s[r][j] = s;
    }
    __syncthreads();
    // online softmax update, one warp per head, one lane per key
    for (int r = warp; r < G; r += kWarps) {
      const bool valid = k0 + lane < kv_end;
      const float s = p_s[r][lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int idx = tid + i * kThreads;
      if (idx >= G * kCol4) break;
      const int r = idx / kCol4, c4 = idx % kCol4;
      const float c = c_s[r];
      float4 a = acc[i];
      a.x *= c; a.y *= c; a.z *= c; a.w *= c;
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) {
        const float p = p_s[r][j];
        const float4 v = reinterpret_cast<const float4*>(v_s[j])[c4];
        a.x = fmaf(p, v.x, a.x);
        a.y = fmaf(p, v.y, a.y);
        a.z = fmaf(p, v.z, a.z);
        a.w = fmaf(p, v.w, a.w);
      }
      acc[i] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = tid + i * kThreads;
    if (idx >= G * kCol4) break;
    const int r = idx / kCol4, c4 = idx % kCol4;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* o = out + row0 + (size_t)r * D + 4 * c4;
    o[0] = from_f32<T>(acc[i].x / denom);
    o[1] = from_f32<T>(acc[i].y / denom);
    o[2] = from_f32<T>(acc[i].z / denom);
    o[3] = from_f32<T>(acc[i].w / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* ctx_lens, void* out, int B,
                   int H, int Hkv, int page, int T_width,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, ctx_lens, static_cast<T*>(out),
      H, Hkv, page, T_width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const int* tables, const int* ctx_lens, void* out, int B,
                     int H, int Hkv, int D, int page, int T_width,
                     cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, tables, ctx_lens, out, B, H,
                           Hkv, page, T_width, s);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, tables, ctx_lens, out, B, H,
                           Hkv, page, T_width, s);
    case 80:
      return launch<T, 80>(q, k_pages, v_pages, tables, ctx_lens, out, B, H,
                           Hkv, page, T_width, s);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, tables, ctx_lens, out, B, H,
                            Hkv, page, T_width, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* ctx_lens, void* out, int B,
                                      int H, int Hkv, int D, int page,
                                      int T_width, int dtype, int device,
                                      void* stream) {
  if (page != 8 && page != 16 && page != 32) return cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG)
    return cudaErrorInvalidValue;
  if (B > 65535 || T_width < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k_pages, v_pages, tables, ctx_lens, out, B, H,
                           Hkv, D, page, T_width, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, tables, ctx_lens,
                                   out, B, H, Hkv, D, page, T_width, s);
  return cudaErrorInvalidValue;
}
