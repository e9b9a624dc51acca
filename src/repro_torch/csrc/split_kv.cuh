// Split-KV attention: the float32 partials of a lane's context splits and
// their merge, in two layouts.
//
// (1) (m, l, acc), below: csrc/paged_attention.cu (B.3) writes and merges
// them; the layout and the merge take nothing of B.3's own.
//
// (2) (o, lse), split_kv_merge at the end: kernel 1's and B.2's split-K
// partial mode (csrc/paged_chunk_attention.cu) for tensor-parallel serving.
// Each of N partials (shard x split) holds, for every query row, o
// normalised over its keys in float32 and lse, the natural log-sum-exp of
// its scaled scores: the equivalent of (m, l, acc) with acc / l and m +
// log(l) taken by the partial's own kernel, so that one split's partial is
// exactly what a plain version that splits nothing returns, and a row no
// key of the partial reaches is (0, -inf) whatever else the partial held.
//
// A lane's relevant keys [0, kv_end), kv_end = min(ctx, limit), are cut into
// splits of `split` keys; split s covers [s * split, (s + 1) * split).  The
// lane needs n = ceil(kv_end / split) of them.  A lane with n <= 1 has its
// output written by the split kernel itself, normalised, and the merge skips
// it (n = 0: a ctx = 0 lane, exact zeros).  For n > 1 every split CTA s < n
// of (lane b, kv head h) writes, for each of its G query heads g:
//   m[b][h][s][g]        the running maximum of its scores,
//   l[b][h][s][g]        sum over its keys of exp(score - m),
//   acc[b][h][s][g][d]   sum over its keys of exp(score - m) * v[d],
// and the merge forms, with M = max_s m:
//   out[d] = sum_s exp(m_s - M) acc_s[d] / max(sum_s exp(m_s - M) l_s, 1e-30)
// in float32 and writes it in the output's dtype.  D is a multiple of 4 and
// at most 128; the workspace's acc rows are 16-byte aligned.  The three arrays sit one
// after the other (acc from a multiple of 4 floats) in one float32 workspace
// of split_kv_floats(...) floats.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kSplitMaskValue = -1e30f;   // the TPU kernel's mask value

// floats of m and l, rounded up to a multiple of 4 so that acc's rows are
// 16-byte aligned
__host__ __device__ __forceinline__ size_t split_kv_ml(int B, int Hkv,
                                                       int n_split, int G) {
  return (2 * (size_t)B * Hkv * n_split * G + 3) / 4 * 4;
}

// floats of the workspace for B lanes, Hkv kv heads, n_split splits, G query
// heads per kv head and head dim D
__host__ __device__ __forceinline__ size_t split_kv_floats(int B, int Hkv,
                                                           int n_split, int G,
                                                           int D) {
  return split_kv_ml(B, Hkv, n_split, G) + (size_t)B * Hkv * n_split * G * D;
}

struct SplitKv {
  float* m;
  float* l;
  float* acc;
  __host__ __device__ SplitKv(float* ws, int B, int Hkv, int n_split, int G)
      : m(ws),
        l(ws + (size_t)B * Hkv * n_split * G),
        acc(ws + split_kv_ml(B, Hkv, n_split, G)) {}
  // index of (lane b, kv head h, split s, head g) in m and l; times D in acc
  static __device__ __forceinline__ size_t row(int b, int h, int s, int g,
                                               int Hkv, int n_split, int G) {
    return (((size_t)b * Hkv + h) * n_split + s) * G + g;
  }
};

// the number of splits lane b needs
__device__ __forceinline__ int split_kv_count(int ctx, int limit, int split) {
  const int kv_end = ctx > 0 ? min(ctx, limit) : 0;
  return (kv_end + split - 1) / split;
}

template <typename T> __device__ __forceinline__ T split_kv_out(float x);
template <> __device__ __forceinline__ float split_kv_out<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
split_kv_out<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

constexpr int kSplitMax = 128;       // splits a lane may have
constexpr int kCombineThreads = 128;
constexpr int kCombineParts = kCombineThreads / 32;  // split partitions

// The merge: one CTA per output row (query head g of kv head h of lane b),
// grid (G, Hkv, B); out (B, H, D) with H = Hkv * G, head h * G + g.  Lanes
// with fewer than two splits were written by the split kernel and are left
// alone.  Warp 0 forms the row's weights exp(m_s - M) / L in shared memory;
// then 32 columns of float4 x kCombineParts partitions of the splits read
// the partial accumulators (independent loads, unrolled) and a shared-memory
// sum over the partitions writes the row.  n_split <= kSplitMax.
template <typename T>
__global__ void split_kv_combine(const float* __restrict__ ws,
                                 const int* __restrict__ ctx_lens,
                                 T* __restrict__ out, int B, int Hkv, int G,
                                 int D, int limit, int split, int n_split) {
  __shared__ float w_s[kSplitMax];
  __shared__ float4 part_s[kCombineParts][32];
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = split_kv_count(ctx_lens[b], limit, split);
  if (n <= 1) return;
  const SplitKv p(const_cast<float*>(ws), B, Hkv, n_split, G);
  const size_t r0 = SplitKv::row(b, h, 0, g, Hkv, n_split, G);
  const int tid = threadIdx.x;
  if (tid < 32) {
    float M = kSplitMaskValue;
    for (int s = tid; s < n; s += 32) M = fmaxf(M, p.m[r0 + (size_t)s * G]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = tid; s < n; s += 32) {
      const size_t r = r0 + (size_t)s * G;
      const float e = expf(p.m[r] - M);
      w_s[s] = e;
      L = fmaf(p.l[r], e, L);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = tid; s < n; s += 32) w_s[s] *= inv;
  }
  __syncthreads();
  const int c4 = tid % 32, part = tid / 32;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (4 * c4 < D) {
#pragma unroll 4
    for (int s = part; s < n; s += kCombineParts) {
      const float w = w_s[s];
      const float4 v = *reinterpret_cast<const float4*>(
          p.acc + (r0 + (size_t)s * G) * D + 4 * c4);
      a.x = fmaf(w, v.x, a.x);
      a.y = fmaf(w, v.y, a.y);
      a.z = fmaf(w, v.z, a.z);
      a.w = fmaf(w, v.w, a.w);
    }
  }
  part_s[part][c4] = a;
  __syncthreads();
  if (part == 0 && 4 * c4 < D) {
#pragma unroll
    for (int q = 1; q < kCombineParts; ++q) {
      const float4 v = part_s[q][c4];
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    T* o = out + (((size_t)b * Hkv + h) * G + g) * D + 4 * c4;
    o[0] = split_kv_out<T>(a.x);
    o[1] = split_kv_out<T>(a.y);
    o[2] = split_kv_out<T>(a.z);
    o[3] = split_kv_out<T>(a.w);
  }
}

// -inf: the lse of a partial that saw no key for the row
__device__ __forceinline__ float split_kv_neg_inf() {
  return __int_as_float(0xff800000);
}

constexpr int kMergeThreads = 128;
constexpr int kMergeRows = kMergeThreads / 32;       // a warp a row

// The (o, lse) merge: part[N][R][D] and lse[N][R] float32 for R query rows
// (b, position, head) and N partials; out[R][D] in T.  With M = max_i
// lse_i, out = sum_i exp(lse_i - M) o_i / sum_i exp(lse_i - M), in
// float32, the terms added in the order i = 0, 1, ..., N - 1, so the result
// does not depend on timing; a partial whose lse is -inf has no weight and
// its o is not read, and a row whose lse are all -inf is written as zeros.
// One warp a row: lane c holds columns 4 c .. 4 c + 3 (D <= 128, a multiple
// of 4); the loads of four partials are issued before their sums.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
split_kv_merge(const float* __restrict__ part, const float* __restrict__ lse,
               T* __restrict__ out, int N, long long R, int D) {
  const long long row =
      (long long)blockIdx.x * kMergeRows + threadIdx.x / 32;
  const int c = threadIdx.x % 32;
  if (row >= R) return;
  float M = split_kv_neg_inf();
  for (int i = c; i < N; i += 32) M = fmaxf(M, lse[(size_t)i * R + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const bool col = 4 * c < D;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  if (M != split_kv_neg_inf()) {
    for (int i0 = 0; i0 < N; i0 += 4) {
      float w[4];
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k;
        const float x = i < N ? lse[(size_t)i * R + row] : split_kv_neg_inf();
        w[k] = x == split_kv_neg_inf() ? 0.f : expf(x - M);
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col && w[k] != 0.f)
          v[k] = *reinterpret_cast<const float4*>(
              part + ((size_t)i * R + row) * D + 4 * c);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        den += w[k];
        a.x = fmaf(w[k], v[k].x, a.x);
        a.y = fmaf(w[k], v[k].y, a.y);
        a.z = fmaf(w[k], v[k].z, a.z);
        a.w = fmaf(w[k], v[k].w, a.w);
      }
    }
  }
  if (!col) return;
  if (den > 0.f) {
    a.x /= den; a.y /= den; a.z /= den; a.w /= den;
  }
  T* o = out + row * D + 4 * c;
  o[0] = split_kv_out<T>(a.x);
  o[1] = split_kv_out<T>(a.y);
  o[2] = split_kv_out<T>(a.z);
  o[3] = split_kv_out<T>(a.w);
}

}  // namespace
