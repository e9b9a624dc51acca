// Mixed-batch causal attention over a paged KV pool, for Hopper (sm_90a).
//
// Two kernels share one body (template parameter kQuant), as the TPU
// kernels share `_chunk_body`:
//   * paged_chunk_attention_launch replaces the TPU kernel
//     `paged_chunk_attention` in src/repro/kernels/paged_attention.py (body
//     `_chunk_body`, index map `_chunk_kv_index`);
//   * paged_chunk_attention_quant_launch replaces
//     `paged_chunk_attention_quant` (`_chunk_kernel_quant`) of the same file:
//     each page whose flag is set is read from the int8 shadow pools and
//     multiplied by that page's float32 scale (no rounding to the model
//     dtype), the others from the fp pools.  Unlike the TPU kernel, which
//     fetches both tiles of every page, it reads only the tile the flag
//     selects, so a quantized page costs half the bytes of a bf16 one (a
//     quarter of a float32 one).  With every flag clear it does exactly the
//     loads and the arithmetic of the fp kernel, so its output is
//     bit-identical.
//
// What both compute: lane b's query i sits at position q_offsets[b] + i and attends, with a float32
// online softmax (m, l, acc), to the keys with kpos <= qpos and
// kpos < ctx_lens[b], read through the lane's block-table row.  GQA: the G =
// H / Hkv query heads of one kv head share its K/V.  A lane's chunk ends at
// its context's end, so query rows at qpos >= ctx_lens[b] are bucket
// padding: the kernel writes them as zeros and reads no K/V for them (the
// TPU kernel computes them; nothing reads them).  A lane with ctx = 0 is all
// padding.
//
// Design.  One CTA of 128 threads owns one (lane, kv head, query tile).  A
// query tile is kRows = 16 rows: bq = 16 / G query positions times the G
// heads (4 x 4 for llama3-8b), so decode (Sq = 1) uses G of its rows.  The
// CTA reads its own lane's q_offset, ctx and table row (there is no scalar
// prefetch), and walks only the lane's RELEVANT keys, kpos <
// min(ctx, horizon of the tile's last query + 1), 32 keys per step.  Four
// threads load each key's row with 16-byte loads (one table lookup each),
// one step ahead into registers, so the next step's loads are in flight
// while this step computes; the rows are staged in shared memory as float32
// (scores and softmax in float32 as on the TPU); the CTA computes the
// 16 x 32 score tile, runs one warp per row for the online softmax update,
// and accumulates P.V in registers.  Table columns past the relevant pages
// are never read, whatever they hold.
//
// What bounds it.  Decode and short chunks are bound by bytes: each lane's
// relevant K/V pages must be read once (the FLOPs per byte are G / 2 per
// head, far below the card's ~295 bf16 FLOPs per byte).  Long chunks become
// bound by operations.  In the int8 kernel a flagged page's rows cost one
// byte an element instead of two (bf16) or four (float32), plus two float32
// scales a page, so decode over a mostly quantized history moves about half
// the bytes of the bf16 kernel.
//
// Head dims 64, 80 and 128.  At 80 (zamba2-2.7b's shared attention) a key
// row is 20 16-byte vectors in float32, 10 in bf16 and 5 in int8, which
// four loaders cannot always split evenly, so each takes ceil(vectors / 4)
// of them and the last takes fewer; and the P.V
// accumulators cover 96 columns (3 float4s per thread) of which the 16 pad
// columns read zeros and are never written.  At 64 and 128 every loader's
// share and the P.V columns are what they were, so those outputs are
// bit-identical to the kernel before head dim 80 was added.
//
// What this simple version leaves on the table: the math runs on the CUDA
// cores in float32, not on the tensor cores (no mma/wgmma); the load
// pipeline is one step deep through registers (no cp.async or TMA ring of
// stages); and there is no split-KV, so a decode batch gives only B x Hkv
// CTAs (64 at B = 8 for llama3-8b) on 132 SMs, each walking its whole
// context alone.  Every query tile of a long chunk re-reads its lane's K/V
// (from L2, mostly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;              // query rows (positions x heads) per CTA
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

// 16 int8 codes times their page's scale, as float32 in smem: one float32
// multiply each, exactly the plain version's int8 * scale
__device__ __forceinline__ void widen_i8(const uint4& u, float* dst,
                                        float scale) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4((float)c[i] * scale, (float)c[i + 1] * scale,
                    (float)c[i + 2] * scale, (float)c[i + 3] * scale);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// q (B, Sq, H, D); k/v pages (P, page, Hkv, D); tables (B, T) int32;
// q_offsets, ctx_lens (B,) int32; out (B, Sq, H, D).  kQuant adds the int8
// pools kq/vq (P, page, Hkv, D), the float32 scales (P,) and the int32
// flags (P,); without it they are null.  All contiguous, the pools 16-byte
// aligned.
template <typename T, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_chunk_attention_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int8_t* __restrict__ kq_pages,
                             const int8_t* __restrict__ vq_pages,
                             const float* __restrict__ k_scales,
                             const float* __restrict__ v_scales,
                             const int* __restrict__ page_quant,
                             const int* __restrict__ tables,
                             const int* __restrict__ q_offsets,
                             const int* __restrict__ ctx_lens,
                             T* __restrict__ out, int Sq, int H, int Hkv,
                             int page, int T_width, int bq) {
  constexpr int kTpr = kThreads / kRows;  // threads per row in P.V (8)
  // P.V columns padded to a multiple of 4 * kTpr (D = 80 -> 96); the pad
  // columns of v_s are zeros and are never written out
  constexpr int kDp = (D + 4 * kTpr - 1) / (4 * kTpr) * (4 * kTpr);
  constexpr int kCol4 = kDp / (4 * kTpr); // float4 accumulators per thread
  constexpr int kPerVec = 16 / sizeof(T); // elements per 16-byte load
  // a key row is kRowVecs 16-byte vectors (kRowVecsQ in int8); loader seg
  // takes vectors [seg * kVecs, seg * kVecs + kVecs) of them, the last
  // loader fewer where kSeg does not divide the row (D = 80 in bf16, int8)
  constexpr int kRowVecs = D * (int)sizeof(T) / 16;
  constexpr int kVecs = (kRowVecs + kSeg - 1) / kSeg;
  constexpr int kRowVecsQ = D / 16;
  constexpr int kVecsQ = (kRowVecsQ + kSeg - 1) / kSeg;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) float q_s[kRows][D];
  __shared__ __align__(16) float k_s[kKeys][D + 4];  // +4: conflict-free
  __shared__ __align__(16) float v_s[kKeys][kDp];
  __shared__ float p_s[kRows][kKeys + 1];
  __shared__ float m_s[kRows], l_s[kRows], c_s[kRows];

  const int G = H / Hkv;
  const int rows = bq * G;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int ctx = ctx_lens[b];
  const int qoff = q_offsets[b];
  // the lane's real query rows: its chunk ends at the context's end, so a
  // row at qpos >= ctx is bucket padding (all rows of a ctx = 0 lane)
  const int q_end = ctx > 0 ? max(0, min(Sq, ctx - qoff)) : 0;
  if (q0 >= q_end) {  // a tile of padding rows: zeros, no K/V read
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, qi = q0 + r / G;
      if (qi < Sq)
        out[(((size_t)b * Sq + qi) * H + h * G + r % G) * D + i % D] =
            from_f32<T>(0.f);
    }
    return;
  }
  const int q_last = min(q0 + bq, q_end) - 1;
  // relevant keys of this tile: up to the causal horizon of its last real
  // query (which is before the context's end); never past the table
  const int kv_end = min(qoff + q_last + 1, T_width * page);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r / G;
    float x = 0.f;
    if (r < rows && qi < q_end)
      x = to_f32(q[(((size_t)b * Sq + qi) * H + h * G + r % G) * D + d]);
    q_s[r][d] = x;
  }
  if (tid < kRows) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }
  if constexpr (kDp > D) {
    for (int i = tid; i < kKeys * (kDp - D); i += kThreads)
      v_s[i / (kDp - D)][D + i % (kDp - D)] = 0.f;
  }

  // loader role: thread tid stages its vectors of key ld_j of every step,
  // prefetched into registers one step ahead
  const int ld_j = tid / kSeg;
  const int seg = tid % kSeg;
  const int* table = tables + (size_t)b * T_width;
  uint4 k_reg[kVecs], v_reg[kVecs];
  // kQuant: whether the staged row comes from the int8 pools, and its
  // page's scales (one flag and one scale lookup per row, not per element)
  bool row_q = false;
  float row_ks = 0.f, row_vs = 0.f;
  auto fetch = [&](int k0) {
    const int kpos = k0 + ld_j;
    row_q = false;
    if (kpos < kv_end) {
      const size_t pid = (size_t)table[kpos / page];
      const size_t off = ((pid * page + kpos % page) * Hkv + h) * D;
      if constexpr (kQuant) {
        if (page_quant[pid]) {  // only the int8 tile: 1 byte an element
          row_q = true;
          row_ks = k_scales[pid];
          row_vs = v_scales[pid];
          const uint4* ks = reinterpret_cast<const uint4*>(kq_pages + off);
          const uint4* vs = reinterpret_cast<const uint4*>(vq_pages + off);
#pragma unroll
          for (int v = 0; v < kVecsQ; ++v) {
            const int vi = seg * kVecsQ + v;
            if (kRowVecsQ % kSeg == 0 || vi < kRowVecsQ) {
              k_reg[v] = __ldg(ks + vi);
              v_reg[v] = __ldg(vs + vi);
            }
          }
          return;
        }
      }
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

  const int pv_row = tid / kTpr;
  const int pv_col = tid % kTpr;
  float4 acc[kCol4];
#pragma unroll
  for (int i = 0; i < kCol4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float scale = 1.f / sqrtf((float)D);

  if (kv_end > 0) fetch(0);
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
    bool staged = false;
    if constexpr (kQuant) {
      if (row_q) {
#pragma unroll
        for (int v = 0; v < kVecsQ; ++v) {
          const int vi = seg * kVecsQ + v;
          if (kRowVecsQ % kSeg == 0 || vi < kRowVecsQ) {
            widen_i8(k_reg[v], &k_s[ld_j][vi * 16], row_ks);
            widen_i8(v_reg[v], &v_s[ld_j][vi * 16], row_vs);
          }
        }
        staged = true;
      }
    }
    if (!staged) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int vi = seg * kVecs + v;
        if (kRowVecs % kSeg == 0 || vi < kRowVecs) {
          widen(k_reg[v], &k_s[ld_j][vi * kPerVec], T());
          widen(v_reg[v], &v_s[ld_j][vi * kPerVec], T());
        }
      }
    }
    __syncthreads();
    if (k0 + kKeys < kv_end) fetch(k0 + kKeys);  // in flight during the math
    // scores: a warp takes one row (kKeys == 32), a lane one key
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i % kKeys;
      const int qi = q0 + r / G;
      const int kpos = k0 + j;
      float s = kMaskValue;
      if (r < rows && qi < q_end && kpos < kv_end && kpos <= qoff + qi) {
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
    // online softmax update, one warp per row, one lane per key
    for (int r = warp; r < rows; r += kWarps) {
      const int qi = q0 + r / G;
      const int kpos = k0 + lane;
      const bool valid = qi < q_end && kpos < kv_end && kpos <= qoff + qi;
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
    if (pv_row < rows) {
      const float c = c_s[pv_row];
#pragma unroll
      for (int i = 0; i < kCol4; ++i) {
        acc[i].x *= c; acc[i].y *= c; acc[i].z *= c; acc[i].w *= c;
      }
      for (int j = 0; j < kKeys; ++j) {
        const float p = p_s[pv_row][j];
        const float4* vrow = reinterpret_cast<const float4*>(v_s[j]);
#pragma unroll
        for (int i = 0; i < kCol4; ++i) {
          const float4 v = vrow[pv_col + i * kTpr];
          acc[i].x = fmaf(p, v.x, acc[i].x);
          acc[i].y = fmaf(p, v.y, acc[i].y);
          acc[i].z = fmaf(p, v.z, acc[i].z);
          acc[i].w = fmaf(p, v.w, acc[i].w);
        }
      }
    }
  }
  __syncthreads();

  const int r = pv_row;
  const int qi = q0 + r / G;
  if (r < rows && qi < Sq) {
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h * G + r % G) * D;
#pragma unroll
    for (int i = 0; i < kCol4; ++i) {
      const int col = 4 * (pv_col + i * kTpr);
      if (kDp > D && col >= D) continue;   // a pad column
      o[col + 0] = from_f32<T>(acc[i].x / denom);
      o[col + 1] = from_f32<T>(acc[i].y / denom);
      o[col + 2] = from_f32<T>(acc[i].z / denom);
      o[col + 3] = from_f32<T>(acc[i].w / denom);
    }
  }
}

// the int8 state of the quant kernel; all null for the fp kernel
struct QuantArgs {
  const int8_t* kq_pages;
  const int8_t* vq_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_quant;
};

template <typename T, int D, bool kQuant>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const QuantArgs& qa, const int* tables,
                   const int* q_offsets, const int* ctx_lens, void* out,
                   int B, int Sq, int H, int Hkv, int page, int T_width,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  int bq = kRows / G;
  if (bq > Sq) bq = Sq;
  const dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  paged_chunk_attention_kernel<T, D, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), qa.kq_pages, qa.vq_pages, qa.k_scales,
      qa.v_scales, qa.page_quant, tables, q_offsets, ctx_lens,
      static_cast<T*>(out), Sq, H, Hkv, page, T_width, bq);
  return cudaGetLastError();
}

template <bool kQuant>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const QuantArgs& qa, const int* tables, const int* q_offsets,
             const int* ctx_lens, void* out, int B, int Sq, int H, int Hkv,
             int D, int page, int T_width, int dtype, int device,
             void* stream) {
  if (page != 8 && page != 16 && page != 32) return cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kRows) return cudaErrorInvalidValue;
  if (B > 65535 || Hkv > 65535) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64, kQuant>(q, k_pages, v_pages, qa, tables,
                                     q_offsets, ctx_lens, out, B, Sq, H, Hkv,
                                     page, T_width, s);
  if (dtype == 0 && D == 80)
    return launch<float, 80, kQuant>(q, k_pages, v_pages, qa, tables,
                                     q_offsets, ctx_lens, out, B, Sq, H, Hkv,
                                     page, T_width, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128, kQuant>(q, k_pages, v_pages, qa, tables,
                                      q_offsets, ctx_lens, out, B, Sq, H, Hkv,
                                      page, T_width, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, kQuant>(q, k_pages, v_pages, qa, tables,
                                             q_offsets, ctx_lens, out, B, Sq,
                                             H, Hkv, page, T_width, s);
  if (dtype == 1 && D == 80)
    return launch<__nv_bfloat16, 80, kQuant>(q, k_pages, v_pages, qa, tables,
                                             q_offsets, ctx_lens, out, B, Sq,
                                             H, Hkv, page, T_width, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, kQuant>(q, k_pages, v_pages, qa,
                                              tables, q_offsets, ctx_lens,
                                              out, B, Sq, H, Hkv, page,
                                              T_width, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* q_offsets, const int* ctx_lens, void* out,
    int B, int Sq, int H, int Hkv, int D, int page, int T_width, int dtype,
    int device, void* stream) {
  const QuantArgs none = {nullptr, nullptr, nullptr, nullptr, nullptr};
  return dispatch<false>(q, k_pages, v_pages, none, tables, q_offsets,
                         ctx_lens, out, B, Sq, H, Hkv, D, page, T_width,
                         dtype, device, stream);
}

// The int8 kernel: kq/vq_pages (P, page, Hkv, D) int8, k/v_scales (P,)
// float32, page_quant (P,) int32 (nonzero = read the int8 pools).
extern "C" int paged_chunk_attention_quant_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kq_pages, const void* vq_pages, const float* k_scales,
    const float* v_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, void* out, int B, int Sq,
    int H, int Hkv, int D, int page, int T_width, int dtype, int device,
    void* stream) {
  const QuantArgs qa = {static_cast<const int8_t*>(kq_pages),
                        static_cast<const int8_t*>(vq_pages), k_scales,
                        v_scales, page_quant};
  return dispatch<true>(q, k_pages, v_pages, qa, tables, q_offsets, ctx_lens,
                        out, B, Sq, H, Hkv, D, page, T_width, dtype, device,
                        stream);
}
