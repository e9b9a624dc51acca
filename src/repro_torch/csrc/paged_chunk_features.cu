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
// a shard, not by products.  So they run on the CUDA cores in float32, with
// one vector load a key's features (2-16 bytes) and no tensor cores (a
// k-dim of 8 would fill a sixteenth of a wgmma's).  The scores buffer of a
// long chunk step is large (8 lanes x 512 rows x 32 heads x 4096 keys is
// 2 GiB), and every shard of a card passes over it: the wrapper's caller
// caps it and tiles over lanes.
//
// F1: a CTA owns kKeys consecutive key positions of one (lane, kv head) and
// a tile of q_rows query rows; it stages those rows' G heads' features in
// shared memory as float32, each thread loads its key's features once (a
// table lookup and one vector load) and writes the G x q_rows products its
// key takes part in, so that a warp writes 128 contiguous bytes of a score
// row at a time.  CTAs past the tile's horizon min(ctx, qoff + last real row
// + 1) return before reading anything.
//
// F2: one warp a (lane, query row, head): each lane walks keys lane, lane +
// 32, ... below the row's horizon with its own online softmax (m, l and DR
// accumulators in registers, exp2 of pre-scaled scores), reading 32
// contiguous scores a step; the warp then merges the lanes' (m, l, acc) by
// shuffles.  V is read again for each row of a (lane, kv head): it is small
// beside the scores and stays in L2.
//
// Launch functions return a cudaError_t (0 = launched); they check the
// launch with cudaGetLastError and never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kKeys = 128;           // F1: key positions a CTA, one a thread
constexpr int kQFloats = 4096;       // F1: q features a CTA stages (16 KiB)
constexpr int kMaxRows = 16;         // F1: query rows a CTA at most
constexpr int kPvWarps = 8;          // F2: rows a CTA, one a warp

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

template <int N> struct Bytes;
template <> struct Bytes<2> { using type = uint16_t; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

// DR elements of type E at p as float32, in loads of up to 16 bytes; p is
// aligned to min(16, DR * sizeof(E)) bytes (a row of a 16-byte aligned pool
// always is).
template <typename E, int DR>
__device__ __forceinline__ void load_row(const E* __restrict__ p,
                                         float (&out)[DR]) {
  constexpr int kRow = DR * static_cast<int>(sizeof(E));
  constexpr int kVec = kRow < 16 ? kRow : 16;
  constexpr int kPer = kVec / static_cast<int>(sizeof(E));
  using V = typename Bytes<kVec>::type;
#pragma unroll
  for (int c = 0; c < DR; c += kPer) {
    const V v = __ldg(reinterpret_cast<const V*>(p + c));
    const E* e = reinterpret_cast<const E*>(&v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[c + j] = to_f32(e[j]);
  }
}

// A key's features: from the int8 shadow times the page's scale where the
// page is flagged (kQuant), else from the fp pool.
template <typename T, int DR, bool kQuant>
__device__ __forceinline__ void key_row(const T* __restrict__ pages,
                                        const int8_t* __restrict__ qpages,
                                        const float* __restrict__ scales,
                                        const int* __restrict__ page_quant,
                                        int pg, long long off,
                                        float (&out)[DR]) {
  if (kQuant && page_quant[pg] != 0) {
    load_row<int8_t, DR>(qpages + off, out);
    const float s = scales[pg];
#pragma unroll
    for (int d = 0; d < DR; ++d) out[d] *= s;
  } else {
    load_row<T, DR>(pages + off, out);
  }
}

// ---------------------------------------------------------------------------
// F1: the shard's partial scores
// ---------------------------------------------------------------------------

template <typename T, int DR, bool kQuant>
__global__ void __launch_bounds__(kKeys) feature_scores(
    const T* __restrict__ q, int qsb, int qss, int qsh,
    const T* __restrict__ k_pages, const int8_t* __restrict__ kq_pages,
    const float* __restrict__ k_scales, const int* __restrict__ page_quant,
    const int* __restrict__ tables, const int* __restrict__ q_offsets,
    const int* __restrict__ ctx_lens, float* __restrict__ scores, int Sq,
    int H, int Hkv, int page, int T_width, int q_rows, int accumulate) {
  __shared__ float qs[kQFloats];
  const int G = H / Hkv;
  const int b = blockIdx.z / Hkv, hk = blockIdx.z % Hkv;
  const int i0 = blockIdx.y * q_rows;
  const int qoff = q_offsets[b], ctx = ctx_lens[b];
  // real rows of the tile: i < Sq and qpos = qoff + i < ctx
  const int i_end = min(min(i0 + q_rows, Sq), ctx - qoff);
  if (i_end <= i0) return;
  const int kv_end = min(ctx, qoff + i_end);  // keys any row here sees
  const int k0 = blockIdx.x * kKeys;
  if (k0 >= kv_end) return;
  const int n_q = (i_end - i0) * G * DR;
  for (int e = threadIdx.x; e < n_q; e += kKeys) {
    const int d = e % DR, g = (e / DR) % G, i = e / (DR * G);
    qs[e] = to_f32(q[(long long)b * qsb + (long long)(i0 + i) * qss +
                     (long long)(hk * G + g) * qsh + d]);
  }
  __syncthreads();
  const int kpos = k0 + threadIdx.x;
  if (kpos >= kv_end) return;
  const int pg = tables[(long long)b * T_width + kpos / page];
  const long long off =
      (((long long)pg * page + kpos % page) * Hkv + hk) * DR;
  float k[DR];
  key_row<T, DR, kQuant>(k_pages, kq_pages, k_scales, page_quant, pg, off,
                         k);
  const long long T_len = (long long)T_width * page;
  for (int i = max(i0, kpos - qoff); i < i_end; ++i) {
    for (int g = 0; g < G; ++g) {
      const float* qr = qs + ((i - i0) * G + g) * DR;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DR; ++d) acc = fmaf(qr[d], k[d], acc);
      float* dst = scores +
                   (((long long)b * H + hk * G + g) * Sq + i) * T_len + kpos;
      *dst = accumulate ? *dst + acc : acc;
    }
  }
}

// ---------------------------------------------------------------------------
// F2: softmax of the summed scores times the shard's V features
// ---------------------------------------------------------------------------

template <typename T, int DR, bool kQuant>
__global__ void __launch_bounds__(kPvWarps * 32) feature_softmax_pv(
    const float* __restrict__ scores, const T* __restrict__ v_pages,
    const int8_t* __restrict__ vq_pages, const float* __restrict__ v_scales,
    const int* __restrict__ page_quant, const int* __restrict__ tables,
    const int* __restrict__ q_offsets, const int* __restrict__ ctx_lens,
    T* __restrict__ out, int B, int Sq, int H, int Hkv, int page,
    int T_width, float scale_log2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kPvWarps + warp;
  if (row >= (long long)B * Sq * H) return;
  // out's order: (b, i, h)
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>((row / H) % Sq);
  const int b = static_cast<int>(row / ((long long)H * Sq));
  const int hk = h / (H / Hkv);
  const int qpos = q_offsets[b] + i, ctx = ctx_lens[b];
  T* dst = out + row * DR;
  const int n_vis = qpos < ctx ? qpos + 1 : 0;  // keys [0, n_vis) visible
  if (n_vis == 0) {               // bucket padding, or a ctx = 0 lane
    for (int d = lane; d < DR; d += 32) dst[d] = from_f32<T>(0.f);
    return;
  }
  const long long T_len = (long long)T_width * page;
  const float* srow = scores + (((long long)b * H + h) * Sq + i) * T_len;
  const int* trow = tables + (long long)b * T_width;
  float m = __int_as_float(0xff800000), l = 0.f;
  float acc[DR];
#pragma unroll
  for (int d = 0; d < DR; ++d) acc[d] = 0.f;
  for (int kpos = lane; kpos < n_vis; kpos += 32) {
    const float s = srow[kpos] * scale_log2;
    const int pg = trow[kpos / page];
    float v[DR];
    key_row<T, DR, kQuant>(v_pages, vq_pages, v_scales, page_quant, pg,
                           (((long long)pg * page + kpos % page) * Hkv + hk) *
                               DR,
                           v);
    if (s > m) {
      const float c = exp2f(m - s);
      l *= c;
#pragma unroll
      for (int d = 0; d < DR; ++d) acc[d] *= c;
      m = s;
    }
    const float p = exp2f(s - m);
    l += p;
#pragma unroll
    for (int d = 0; d < DR; ++d) acc[d] = fmaf(p, v[d], acc[d]);
  }
  float M = m;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
  // a lane that saw no key has m = -inf: it weighs nothing
  const float c = m == __int_as_float(0xff800000) ? 0.f : exp2f(m - M);
  l *= c;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DR; ++d) {
    float a = acc[d] * c;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
    if (d % 32 == lane) dst[d] = from_f32<T>(a * inv);
  }
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
                     int accumulate, cudaStream_t s) {
  const int G = H / Hkv;
  const int q_rows = std::max(1, std::min(kMaxRows, kQFloats / (G * DR)));
  const long long T_len = (long long)T_width * page;
  const dim3 grid(static_cast<unsigned>((T_len + kKeys - 1) / kKeys),
                  static_cast<unsigned>((Sq + q_rows - 1) / q_rows),
                  static_cast<unsigned>(B * Hkv));
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  feature_scores<T, DR, kQuant><<<grid, kKeys, 0, s>>>(
      static_cast<const T*>(q), qsb, qss, qsh, static_cast<const T*>(k_pages),
      qa.kq, qa.k_scales, qa.page_quant, tables, q_offsets, ctx_lens, scores,
      Sq, H, Hkv, page, T_width, q_rows, accumulate);
  return cudaGetLastError();
}

template <typename T, int DR, bool kQuant>
cudaError_t pv_t(const float* scores, const void* v_pages, const Quant& qa,
                 const int* tables, const int* q_offsets, const int* ctx_lens,
                 void* out, int B, int Sq, int H, int Hkv, int page,
                 int T_width, float scale_log2, cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  const long long n_ctas = (rows + kPvWarps - 1) / kPvWarps;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  feature_softmax_pv<T, DR, kQuant>
      <<<static_cast<unsigned>(n_ctas), kPvWarps * 32, 0, s>>>(
          scores, static_cast<const T*>(v_pages), qa.vq, qa.v_scales,
          qa.page_quant, tables, q_offsets, ctx_lens, static_cast<T*>(out), B,
          Sq, H, Hkv, page, T_width, scale_log2);
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
                      int Hkv, int page, int T_width, int accumulate,
                      cudaStream_t s) {
  FEATURE_DISPATCH(scores_t, q, qsb, qss, qsh, k_pages, qa, tables, q_offsets,
                   ctx_lens, scores, B, Sq, H, Hkv, page, T_width, accumulate,
                   s)
}

template <typename T>
cudaError_t pv_dr(int dr, bool quant, const float* scores,
                  const void* v_pages, const Quant& qa, const int* tables,
                  const int* q_offsets, const int* ctx_lens, void* out, int B,
                  int Sq, int H, int Hkv, int page, int T_width,
                  float scale_log2, cudaStream_t s) {
  FEATURE_DISPATCH(pv_t, scores, v_pages, qa, tables, q_offsets, ctx_lens,
                   out, B, Sq, H, Hkv, page, T_width, scale_log2, s)
}

bool shape_ok(int B, int Sq, int H, int Hkv, int page, int T_width,
              int dtype) {
  return B > 0 && Sq > 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= 16 &&
         page > 0 && T_width > 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// F1.  q (B, Sq, H, dr) at element strides (qsb, qss, qsh) and 1 along dr;
// k_pages (P, page, Hkv, dr); the int8 pointers (kq_pages (P, page, Hkv,
// dr), k_scales (P,), page_quant (P,)) null for kernel 1's mode; tables (B,
// T_width), q_offsets and ctx_lens (B,) int32; scores (B, H, Sq, T_width *
// page) float32, written (accumulate 0) or added to (1) where a row sees the
// key.  dtype 0 float32, 1 bfloat16.
extern "C" int paged_chunk_scores_launch(
    const void* q, const void* k_pages, const void* kq_pages,
    const float* k_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, float* scores, int qsb,
    int qss, int qsh, int B, int Sq, int H, int Hkv, int dr, int page,
    int T_width, int accumulate, int dtype, int device, void* stream) {
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
                            T_width, accumulate, s);
  return scores_dr<__nv_bfloat16>(dr, quant, q, qsb, qss, qsh, k_pages, qa,
                                  tables, q_offsets, ctx_lens, scores, B, Sq,
                                  H, Hkv, page, T_width, accumulate, s);
}

// F2.  scores (B, H, Sq, T_width * page) float32, summed over the shards;
// v_pages (P, page, Hkv, dr); the int8 pointers (vq_pages, v_scales,
// page_quant) null for kernel 1's mode; out (B, Sq, H, dr) in V's dtype;
// scale_log2 = log2(e) / sqrt(D) of the full head.
extern "C" int paged_chunk_softmax_pv_launch(
    const float* scores, const void* v_pages, const void* vq_pages,
    const float* v_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, void* out, int B, int Sq,
    int H, int Hkv, int dr, int page, int T_width, float scale_log2,
    int dtype, int device, void* stream) {
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
                        ctx_lens, out, B, Sq, H, Hkv, page, T_width,
                        scale_log2, s);
  return pv_dr<__nv_bfloat16>(dr, quant, scores, v_pages, qa, tables,
                              q_offsets, ctx_lens, out, B, Sq, H, Hkv, page,
                              T_width, scale_log2, s);
}
