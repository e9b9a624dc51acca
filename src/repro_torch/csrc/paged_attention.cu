// Single-token decode attention over a paged KV pool, for Hopper (sm_90a):
// split-KV with a cp.async ring per warp.
//
// paged_attention_launch replaces the TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`, index map
// `kv_index`).  What it computes: lane b's G = H / Hkv query heads of kv
// head h attend, with a float32 online softmax (m, l, acc), to the keys at
// positions < ctx_lens[b], read through row b of the block table.  Only the
// lane's first ceil(ctx / page) table columns are read, whatever the columns
// past them hold (callers repeat the last valid page id).  A lane with
// ctx = 0 writes exact zeros and reads no K/V (the TPU kernel's page walk
// skips every page and divides an empty accumulator by max(l, 1e-30)).  Keys
// past the table's width are never seen, as on the TPU, whose grid walks
// exactly the table's columns.
//
// What bounds it.  Decode is bound by bytes: every relevant K/V row is read
// once, and each K/V element feeds G multiply-adds (QK for K, PV for V), so
// a bf16 byte carries G / 2 multiply-adds (G / 4 in float32), against the
// card's ~295 bf16 tensor-core operations or ~20 float32 CUDA-core
// operations per byte of HBM.  What stood between the first version and
// that bound was latency: one CTA per (lane, kv head) walked the whole
// context alone (8 CTAs at B = 1 for llama3-8b on 132 SMs), one step of
// loads in flight, K/V widened to float32 in shared memory, block-wide
// syncs every 32 keys.
//
// Design.
// - Split the context.  The grid is (n_split, Hkv, B): CTA s of (lane b,
//   kv head h) takes the lane's keys [s * split, (s + 1) * split) that are
//   relevant.  The wrapper picks split (a multiple of 32 keys) and n_split
//   from B x Hkv and the table's width (the most keys a lane can have: the
//   host does not read ctx_lens) so that the grid holds about four CTAs per
//   SM, each with at least 64 keys.  Splits past a lane's own end return at
//   once.
// - A ring per warp.  The four warps of a CTA take the split's 8-key tiles
//   in turn (warp w tiles w, w + 4, ...); a tile lies in one page (pages are
//   8, 16 or 32 keys), so one table lookup serves it, loaded a tile ahead.
//   Each warp streams its K and V rows with cp.async 16-byte copies into its
//   own kStages-deep ring in shared memory (2 to 4 stages, as many as fit
//   48 KB) and waits with cp.async.wait_group and __syncwarp: no block-wide
//   barrier inside the key loop.  Rows past the split's end are zero-filled
//   by the copy, so nothing uninitialised meets p = 0.  Rows are padded by
//   16 bytes, which makes the score reads of 8 rows conflict-free.
// - Products on the CUDA cores in float32, read from bf16 or float32 shared
//   memory as they are.  Lane pair (head g, key k) of a tile scores q_g . K_k
//   (q in float32 in shared memory, a broadcast per 8 lanes); each 8-lane
//   group runs its head's online-softmax update with shuffles; p and the
//   correction go through shared memory to the P.V step, where a lane owns
//   float4 columns of the G x D accumulator.  Why not the tensor cores: at
//   G <= 16 the float32 CUDA cores do 67 TFLOP/s against the ~4 x G / 2
//   TFLOP/s a bf16 decode at 3.35 TB/s asks for (13-107 TFLOP/s only at G =
//   16, 4-27 at llama3-8b's G = 4), so the bytes bound is in reach on the
//   CUDA cores; an mma.sync m16n8k16 body would pad G to 16 rows.  Phase
//   14 reads this body at 0.3-0.6 of the bytes bound at G = 1 and 4
//   (PERF.md), where the products are far from the CUDA cores' rate.
// - Merge.  At the end of the split the four warps' (m, l, acc) are merged
//   in shared memory.  A lane that needs one split writes its normalised
//   output there and then; otherwise the split writes its float32 partial
//   (csrc/split_kv.cuh) to a workspace the wrapper allocated, and a second
//   kernel, split_kv_combine, merges the lane's splits.  With a single split
//   for every lane (short tables) the wrapper launches no merge at all.
//
// Tried and not kept: nothing was timed against this body before it was
// written; the first version (one CTA per (lane, kv head), 32 keys a step
// through registers, float32 staging) is the earlier row of PERF.md's table.
//
// Head dims 32, 64, 80 and 128; pages of 8, 16 and 32; G from 1 to 16;
// float32 and bfloat16.  The host wrapper checks these before it launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"
#include "split_kv.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;                 // query heads per kv head
constexpr int kWK = 8;                    // keys of one warp tile
constexpr int kSlots = kMaxG * kWK / 32;  // (head, key) pairs a lane scores
constexpr int kSplitAlign = kWarps * kWK; // a split is whole CTA tiles
constexpr int kBudget = 48 * 1024;        // shared memory a CTA aims at
constexpr float kMaskValue = kSplitMaskValue;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T in shared memory as float32 (8 for bf16, 4 for float)
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void widen16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// 4 consecutive elements of T in shared memory as float4
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// shared-memory layout of one instantiation
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements per copy
  static constexpr int kRowVecs = D / kVec;          // copies per K/V row
  static constexpr int kRow = D + kVec;              // padded row (elements)
  static constexpr int kTile = 2 * kWK * kRow;       // K rows, then V rows
  static constexpr int kCopies = 2 * kWK * kRowVecs / 32;  // per lane
  static constexpr int kQRow = D + 4;                // padded q row (floats)
  static constexpr int kCol4 = D / 4;                // float4 columns
  static constexpr int kOut = kMaxG * kCol4 / 32;    // float4 outputs a lane
  static constexpr int kFixed =
      4 * (kMaxG * kQRow + kWarps * kMaxG * kWK + 3 * kWarps * kMaxG);
  static constexpr int kStageBytes = kWarps * kTile * (int)sizeof(T);
  static constexpr int kFit = (kBudget - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kMerge = 4 * kWarps * kMaxG * D;  // warps' acc
  static constexpr int kSmem = kFixed + (kRing > kMerge ? kRing : kMerge);
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert((2 * kWK * kRowVecs) % 32 == 0, "copies per lane");
  static_assert((kMaxG * kCol4) % 32 == 0, "outputs per lane");
  static_assert(kFixed % 16 == 0, "ring alignment");
};

// q (B, H, D); k/v pages (P, page, Hkv, D); tables (B, T) int32; ctx_lens
// (B,) int32; out (B, H, D); ws the split_kv.cuh workspace (null when
// n_split == 1).  All contiguous, the pools 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ tables,
                      const int* __restrict__ ctx_lens, T* __restrict__ out,
                      float* __restrict__ ws, int B, int H, int Hkv, int page,
                      int T_width, int split, int n_split) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [kMaxG][kQRow]
  float* p_s = q_s + kMaxG * L::kQRow;           // [kWarps][kMaxG][kWK]
  float* c_s = p_s + kWarps * kMaxG * kWK;       // [kWarps][kMaxG]
  float* m_s = c_s + kWarps * kMaxG;             // [kWarps][kMaxG]
  float* l_s = m_s + kWarps * kMaxG;             // [kWarps][kMaxG]
  unsigned char* ring = smem + L::kFixed;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * D;
  const int limit = T_width * page;
  const int ctx = ctx_lens[b];
  const int n_b = split_kv_count(ctx, limit, split);
  if (n_b == 0) {  // an empty lane (or table): zeros, no K/V read
    if (s == 0)
      for (int i = tid; i < G * D; i += kThreads)
        out[row0 + i] = split_kv_out<T>(0.f);
    return;
  }
  if (s >= n_b) return;
  const int k_begin = s * split;
  const int k_stop = min(k_begin + split, min(ctx, limit));

  // this warp's tiles of the split: keys k_begin + (warp + kWarps * i) * kWK
  const int n_tiles = (k_stop - k_begin + kWK - 1) / kWK;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                      : 0;
  const int* table = tables + (size_t)b * T_width;
  T* wring = reinterpret_cast<T*>(ring) + warp * L::kTile;
  auto tile_key = [&](int i) { return k_begin + (warp + kWarps * i) * kWK; };
  auto page_of = [&](int i) {
    return i < my_tiles ? __ldg(table + tile_key(i) / page) : 0;
  };
  // tile i's K and V rows into stage i % kStages, from page pid
  auto issue = [&](int i, int pid) {
    T* dst = wring + (i % L::kStages) * (kWarps * L::kTile);
    const int k0 = tile_key(i);
    const size_t pbase = (size_t)pid * page + k0 % page;
#pragma unroll
    for (int c = 0; c < L::kCopies; ++c) {
      const int v = lane + 32 * c;
      const int kk = v / (2 * L::kRowVecs);
      const int which = (v / L::kRowVecs) % 2;    // 0: K, 1: V
      const int col = v % L::kRowVecs;
      const bool ok = k0 + kk < k_stop;
      const T* base = which ? v_pages : k_pages;
      const T* src = base + ((pbase + kk) * Hkv + h) * D + col * L::kVec;
      cp_async16(dst + (which * kWK + kk) * L::kRow + col * L::kVec,
                 ok ? src : base, ok);
    }
  };

  float m_r[kSlots], l_r[kSlots];
  float4 acc[L::kOut];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    m_r[sl] = kMaskValue;
    l_r[sl] = 0.f;
  }
#pragma unroll
  for (int o = 0; o < L::kOut; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float scale = 1.f / sqrtf((float)D);
  const int kk = lane % kWK;            // this lane's key in each slot
  float* pw = p_s + warp * kMaxG * kWK;
  float* cw = c_s + warp * kMaxG;

  int nxt = 0;                          // the next tile to issue
  int pid = page_of(0);                 // its page
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (nxt < my_tiles) {
      issue(nxt, pid);
      pid = page_of(++nxt);
    }
    cp_async_commit();
  }
  // q while the first tiles are in flight
  for (int i = tid; i < G * D; i += kThreads)
    q_s[(i / D) * L::kQRow + i % D] = to_f32(q[row0 + i]);
  __syncthreads();
  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncwarp();  // tile i landed for every lane; all are past tile i - 1
    if (nxt < my_tiles) {  // into the stage tile i - 1 used
      issue(nxt, pid);
      pid = page_of(++nxt);
    }
    cp_async_commit();
    const T* st = wring + (i % L::kStages) * (kWarps * L::kTile);
    const int k0 = tile_key(i);
    const bool key_ok = k0 + kk < k_stop;
    // scores and the online-softmax update, one 8-lane group per head
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      if (4 * sl >= G) continue;        // warp-uniform
      const int g = lane / kWK + 4 * sl;
      float sc = kMaskValue;
      if (g < G && key_ok) {
        const float* qr = q_s + g * L::kQRow;
        const T* kr = st + kk * L::kRow;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < L::kRowVecs; ++c) {
          float kf[L::kVec];
          widen16(kr + c * L::kVec, kf);
#pragma unroll
          for (int e = 0; e < L::kVec; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qr + c * L::kVec + e);
            dot = fmaf(qv.x, kf[e], dot);
            dot = fmaf(qv.y, kf[e + 1], dot);
            dot = fmaf(qv.z, kf[e + 2], dot);
            dot = fmaf(qv.w, kf[e + 3], dot);
          }
        }
        sc = dot * scale;
      }
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_r[sl], mx);
      const float p = (g < G && key_ok) ? expf(sc - m_new) : 0.f;
      float sum = p;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m_r[sl] - m_new);
      l_r[sl] = fmaf(l_r[sl], corr, sum);
      m_r[sl] = m_new;
      if (g < G) {
        pw[g * kWK + kk] = p;
        if (kk == 0) cw[g] = corr;
      }
    }
    __syncwarp();
    // P.V: a lane owns float4 column c4 of head g for its output slots
#pragma unroll
    for (int o = 0; o < L::kOut; ++o) {
      const int idx = lane + 32 * o;
      if (idx < G * L::kCol4) {
        const int g = idx / L::kCol4, c4 = idx % L::kCol4;
        const float c = cw[g];
        const float4 pa = *reinterpret_cast<const float4*>(pw + g * kWK);
        const float4 pb = *reinterpret_cast<const float4*>(pw + g * kWK + 4);
        const float pv[kWK] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        float4 a = acc[o];
        a.x *= c; a.y *= c; a.z *= c; a.w *= c;
#pragma unroll
        for (int j = 0; j < kWK; ++j) {
          const float4 v = load4(st + (kWK + j) * L::kRow + 4 * c4);
          a.x = fmaf(pv[j], v.x, a.x);
          a.y = fmaf(pv[j], v.y, a.y);
          a.z = fmaf(pv[j], v.z, a.z);
          a.w = fmaf(pv[j], v.w, a.w);
        }
        acc[o] = a;
      }
    }
    __syncwarp();  // p and the corrections are read before the next tile
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // merge the four warps' (m, l, acc) in shared memory
  float* acc_s = reinterpret_cast<float*>(ring);  // [kWarps][kMaxG][D]
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int g = lane / kWK + 4 * sl;
    if (kk == 0 && g < G) {
      m_s[warp * kMaxG + g] = m_r[sl];
      l_s[warp * kMaxG + g] = l_r[sl];
    }
  }
#pragma unroll
  for (int o = 0; o < L::kOut; ++o) {
    const int idx = lane + 32 * o;
    if (idx < G * L::kCol4) {
      const int g = idx / L::kCol4, c4 = idx % L::kCol4;
      *reinterpret_cast<float4*>(acc_s + (warp * kMaxG + g) * D + 4 * c4) =
          acc[o];
    }
  }
  __syncthreads();
  const SplitKv part(ws, B, Hkv, n_split, G);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * kMaxG + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w * kMaxG + g] - M);
      Ls = fmaf(l_s[w * kMaxG + g], e, Ls);
      A = fmaf(acc_s[(w * kMaxG + g) * D + d], e, A);
    }
    if (n_b == 1) {
      out[row0 + i] = split_kv_out<T>(A / fmaxf(Ls, 1e-30f));
    } else {
      const size_t r = SplitKv::row(b, h, s, g, Hkv, n_split, G);
      if (d == 0) {
        part.m[r] = M;
        part.l[r] = Ls;
      }
      part.acc[r * D + d] = A;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* ctx_lens, void* out,
                   float* ws, int B, int H, int Hkv, int page, int T_width,
                   int split, int n_split, cudaStream_t stream) {
  constexpr int smem = Layout<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_split<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, Hkv, B);
  paged_attention_split<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, ctx_lens, static_cast<T*>(out),
      ws, B, H, Hkv, page, T_width, split, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  split_kv_combine<T><<<dim3(H / Hkv, Hkv, B), kCombineThreads, 0, stream>>>(
      ws, ctx_lens, static_cast<T*>(out), B, Hkv, H / Hkv, D,
      T_width * page, split, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const int* tables, const int* ctx_lens, void* out,
                     float* ws, int B, int H, int Hkv, int D, int page,
                     int T_width, int split, int n_split, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, tables, ctx_lens, out, ws, B,
                           H, Hkv, page, T_width, split, n_split, s);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, tables, ctx_lens, out, ws, B,
                           H, Hkv, page, T_width, split, n_split, s);
    case 80:
      return launch<T, 80>(q, k_pages, v_pages, tables, ctx_lens, out, ws, B,
                           H, Hkv, page, T_width, split, n_split, s);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, tables, ctx_lens, out, ws,
                            B, H, Hkv, page, T_width, split, n_split, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t resources_d(int D, int* out) {
  switch (D) {
    case 32:
      return resources(paged_attention_split<T, 32>, kThreads,
                       Layout<T, 32>::kSmem, out);
    case 64:
      return resources(paged_attention_split<T, 64>, kThreads,
                       Layout<T, 64>::kSmem, out);
    case 80:
      return resources(paged_attention_split<T, 80>, kThreads,
                       Layout<T, 80>::kSmem, out);
    case 128:
      return resources(paged_attention_split<T, 128>, kThreads,
                       Layout<T, 128>::kSmem, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  split (keys per split, a multiple of
// 32) and n_split come from the wrapper (kernels/paged_attention.py::
// decode_split_plan) and must cover the table: n_split * split >= T_width *
// page.  ws: split_kv_floats(B, Hkv, n_split, H / Hkv, D) floats, or null
// when n_split == 1.  Launches the split kernel and, for n_split > 1, the
// merge.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* ctx_lens, void* out,
                                      float* ws, int B, int H, int Hkv, int D,
                                      int page, int T_width, int split,
                                      int n_split, int dtype, int device,
                                      void* stream) {
  if (page != 8 && page != 16 && page != 32) return cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || Hkv > 65535)
    return cudaErrorInvalidValue;
  if (B > 65535 || T_width < 0) return cudaErrorInvalidValue;
  if (split <= 0 || split % kSplitAlign != 0 || n_split <= 0 ||
      n_split > kSplitMax)
    return cudaErrorInvalidValue;
  if ((long long)n_split * split < (long long)T_width * page)
    return cudaErrorInvalidValue;
  if (n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k_pages, v_pages, tables, ctx_lens, out, ws, B,
                           H, Hkv, D, page, T_width, split, n_split, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, tables, ctx_lens,
                                   out, ws, B, H, Hkv, D, page, T_width,
                                   split, n_split, s);
  return cudaErrorInvalidValue;
}

// out[5]: registers, local (spill) bytes, shared memory, CTAs per SM and
// threads of the split kernel for (D, dtype), as the runtime reports them.
extern "C" int paged_attention_resources(int D, int dtype, int device,
                                         int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return resources_d<float>(D, out);
  if (dtype == 1) return resources_d<__nv_bfloat16>(D, out);
  return cudaErrorInvalidValue;
}
