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
//     multiplied by that page's float32 scale (no rounding of the
//     dequantised value to the model dtype), the others from the fp pools.
//     Unlike the TPU kernel, which fetches both tiles of every page, it reads
//     only the tile the flag selects, so a quantized page costs half the
//     bytes of a bf16 one (a quarter of a float32 one).  With every flag
//     clear it does exactly the loads and the arithmetic of the fp kernel, so
//     its output is bit-identical.
//
//   * paged_chunk_attention_partial_launch is either kernel's split-K
//     partial mode, for tensor-parallel serving when the kv heads do not
//     divide over the shards: the pools passed are shard r's slice of every
//     page, rows [r * page, (r + 1) * page) of pages of page * n_shards rows,
//     so local row j of table entry t is the key at position t * page *
//     n_shards + r * page + j.  The causal mask and ctx use those positions.
//     A shard page may hold 1 to 32 rows; without a split the mode is the
//     kernel itself (page_g = page, r_off = 0 below), so both bodies gained
//     integer arithmetic only.  The shard's local keys are cut into n_split
//     splits of `split` keys (whole 64-key stages), planned by the wrapper
//     as B.3 plans its decode splits, so that at decode and in short chunks
//     one shard's grid fills the card by itself (a shard at decode is B x
//     Hkv CTAs otherwise: 4 at yi-6b's); a long chunk keeps one split.
//     Every split CTA writes float32 partials: o normalised over its keys
//     and lse, the natural log-sum-exp of their scaled scores, o = 0 and
//     lse = -inf where a row sees no key of the split (csrc/split_kv.cuh's
//     (o, lse) layout).  paged_chunk_attention_merge_launch merges every
//     shard's and split's partials of one call in one launch
//     (split_kv_merge), reading the workspace the shards wrote side by
//     side, as GSPMD's softmax combine does for the TPU kernel.
//
//   * paged_chunk_attention_features_launch is either kernel's route on the
//     head-feature rung of tensor-parallel serving when every shard's pools
//     live on one card: shard r holds features [r * dr, (r + 1) * dr) of
//     every row (D = tp * dr), and one launch a layer computes the full
//     heads' attention straight from the tp pools (kFeat below).  Only the
//     load changes: a key row's D columns are tp runs of dr features, run r
//     read from shard r's pool at the same (page, row, kv head), gathered
//     into the tile that TMA (or the float32 loader) builds from one
//     concatenated pool, so the output is bit-equal to the kernel's on the
//     concatenated pools.  The sum over the shards is the k dimension of
//     Q.K^T, so no float32 scores leave the CTA (the per-shard route,
//     csrc/paged_chunk_features.cu, passes a (B, H, Sq, T) float32 buffer
//     through device memory 47 times a layer at tp 16).  The shards' base
//     pointers come by value in a __grid_constant__ struct (ShardPools, up
//     to kMaxShards = 64).  At dr = 8 with the pools at one stride (a
//     card's shards: PoolLayout.zeros) the bf16 body loads by TMA into
//     tiles of core matrices, else it gathers the runs by cp.async; what
//     bounds each is in the producer's notes.
//
// What both compute: lane b's query i sits at position q_offsets[b] + i and
// attends, with a float32 online softmax (m, l, acc) scaled by 1/sqrt(D), to
// the keys with kpos <= qpos and kpos < ctx_lens[b], read through the lane's
// block-table row; the output is acc / max(l, 1e-30) in q's dtype.  GQA: the
// G = H / Hkv query heads of one kv head share its K/V.  A lane's chunk ends
// at its context's end, so query rows at qpos >= ctx_lens[b] are bucket
// padding: the kernel writes them as zeros and reads no K/V for them (the
// TPU kernel computes them; nothing reads them).  A lane with ctx = 0 is all
// padding.  Table columns past a lane's relevant pages, p >= ceil(kv_end /
// page) for the tile's horizon kv_end, are never read, whatever they hold.
//
// What bounds it.  Each (lane, kv head) must read its relevant K/V pages
// once and does 4 * D operations per (query head, visible key).  Decode
// (one query a lane) does G / 2 operations per K/V byte in bf16: bound by
// bytes.  A chunk of Sq queries does about Sq * G / 2, so from a few dozen
// tokens on it is bound by operations, far above the ~295 operations per
// byte at which bf16 tensor cores stop waiting for memory.  So the remedy is
// the tensor cores, and there are two bodies, one per dtype, behind one
// launch function.
//
// bfloat16: the tensor-core body (paged_chunk_attention_tc), the tile of the
// prefill kernel (csrc/flash_prefill.cu) on paged K/V.  One CTA owns kTcRows =
// 64 query rows of one (lane, kv head): the G heads of bq = 64 / G positions,
// row r = position q0 + r / G, head h * G + r % G, as the TPU kernel packs its
// (bq * G, D) q block; where G does not divide 64 the rows past bq * G are zero
// Q rows that are never written.  One producer warp streams the tile's keys,
// kTcKeys = 64 a stage, into a ring of kTcStages = 2 shared-memory stages by
// TMA, with a full and an empty mbarrier a stage.  The ring follows the block
// table: each pool is one tensor map over (P * page, Hkv, D), a box is one
// page's rows of one kv head, 64 columns wide, so a stage is 64 / page pages,
// each loaded at row table[b][p] * page into the stage's rows p * page, a
// multiple of 1024 bytes at pages of 8 rows or more (TMA swizzles by the
// shared-memory address, so smaller shard pages land as well).  The producer warp
// reads each stage's table entries (with their flags and scales), one or two
// a lane, and each lane issues its own pages' boxes (at split-K shard pages
// of 1 or 2 rows the lanes gather the rows by cp.async instead, into the
// same swizzle); it never loads a page at or past ceil(kv_end / page), and
// expects only the bytes it issues.  One consumer warpgroup runs S =
// Q.K^T as wgmma m64n64k16 (Q and K K-major in 128-byte-swizzled shared
// memory), the online softmax on S's accumulator fragments (exp2 of pre-scaled
// scores, row max by quad shuffles), converts P to bf16 A fragments in
// registers and runs O += P.V as wgmma m64nDk16 with V's [keys][D] tile read as
// the MN-major B operand.  Only tiles that reach past row 0's horizon are
// masked; tiles past the last real row's horizon are neither loaded nor
// computed.  160 threads and 83 KB of shared memory at D = 128 (B.2: 256
// threads, 100 KB) leave two CTAs resident per SM, so one CTA's softmax
// overlaps the other's products.  Blocks are issued highest query tile first across lanes and
// heads.
//   * Garbage never meets p = 0.  The rows of the last stage that no load
//     fills (keys past the lane's relevant pages) are zeroed when the CTA
//     starts, since uninitialised shared memory can hold NaN and 0 * NaN is
//     NaN; a later stage that reuses a ring slot sees the earlier stage's
//     rows there, which are the lane's own K/V.  Rows inside the last
//     relevant page but past kv_end are the lane's own page: they are read
//     and masked, as the TPU kernel reads whole pages.  This assumes that a
//     pool page holds finite values in every row, which the serving pools
//     give: they start as zeros and hold only written K/V.
//   * D = 80 (zamba2-2.7b's shared attention) and D = 96 (phi-3-vision):
//     the tensor maps' D extent is D, so a row's second 64-column box comes
//     back zero past column D; Q.K^T takes D / 16 k16 steps (5, 6) and P.V
//     is m64n80k16 / m64n96k16 across the two column blocks, so no product
//     reads a column past D.  Shared memory is D = 128's (two column blocks
//     a row), so two CTAs stay resident per SM.
//   * int8 pages (kQuant): the consumers never convert.  B.2 runs 256
//     threads: the consumer warpgroup and a producer warpgroup of the
//     producer (warp 4, as in kernel 1) and three converter warps.  The
//     producer fetches each stage's flagged pages' codes by TMA (one box a
//     page and side, unswizzled) into a staging buffer of one stage beside
//     the ring, as soon as the converters are done with the last flagged
//     stage's, so the codes need not wait for the stage's ring slot; once
//     the slot is free the converters write them, a 16-code unit at a
//     time, as bf16 (codes_to_bf16: exact for |code| <= 128, two byte
//     permutes and an add a code, no conversion instruction) into the
//     swizzled rows TMA would have filled, fence them for wgmma, free the
//     staging and arrive on the stage's full barrier (the producer's
//     expect_tx and each converter's arrival).  So the consumers find
//     every row of a full stage in bf16.  The producer converts nothing:
//     its arrival on each full barrier, behind its TMA issue, would set
//     the pace of flag-free stages too.  The two warpgroups trade
//     registers: the CTA is launched with 128 a thread (two CTAs an SM),
//     the producer warpgroup gives back to kCvtProdRegs and the consumers
//     take kCvtConsRegs (setmaxnreg), and the launch is refused if the
//     kernel was built with another count.  Without the trade the 1-row
//     body spills at D = 128, and designs with fewer warps convert too
//     slowly: on an H100 (chip_smoke.py phase 3, int8 chunk of 512 rows,
//     half the pages flagged) the producer and one converter warp
//     converting in the ring slot (192 threads) took 1.5x this design's
//     time, and three warps without the trade (224 threads) are held to
//     128 registers and spill.
//     The page's float32 scales apply where the arithmetic is float32:
//     k_scale multiplies S's columns of that page's keys before the softmax
//     (s_j = (q . kq_j) ks_j), v_scale multiplies P's columns before P is
//     rounded to bf16 (sum_j p_j (vq_j vs_j) = sum_j (p_j vs_j) vq_j); a
//     plain page's columns are not multiplied at all.  A stage may mix both
//     kinds.  Each scale is a pass of its own over S's fragments, before
//     and after kernel 1's softmax, and a stage with no flagged page skips
//     both, so with every flag clear the output is kernel 1's bit for bit.
//     The passes keep the consumers out of local memory: a softmax that
//     looks each key pair's flag and scale up inside its own loops holds
//     them beside S's 32 and O's 64 accumulators, and at D = 128 ptxas
//     stored 10 words of such a body in local memory (4 in the 1-row body):
//     6 around that softmax and 4 long-lived values (a kernel argument, a
//     thread index, the rows' horizons) across the key loop, with the
//     consumers' share set anywhere from 136 to 200 registers (ptxas -v
//     and the LDL / STL lines of its SASS, nvcc 12.9).  On the
//     head-feature rung (kFeat) the producers gather the codes into the
//     tile and the consumers convert them in place.
//   * Decode on a small grid (the unsplit entry).  A grid of n_qblk x Hkv x
//     B CTAs is 8 CTAs on 132 SMs at llama3-8b's decode of one lane, each
//     walking 4096 keys through a 2-stage ring.  Where it holds fewer CTAs
//     than the card has SMs, the wrapper's plan
//     (paged_attention.chunk_split_plan) cuts each (query tile, kv head,
//     lane)'s keys into n_split <= kMaxCluster = 8 splits of whole 64-key
//     stages, the portable cluster size (no non-portable attribute is
//     set), within one wave of two CTAs an SM, none under 512 keys of the
//     table and at least three (a cluster's launch and merge outweigh a
//     few stages, and what two splits save); the splits are the CTAs of
//     one thread-block cluster.  Each runs the body on its keys and keeps o,
//     m and l; the epilogue merges them over distributed shared memory in
//     the same launch (each rank reading every rank's slots of its own
//     thread index and writing a share of the columns), so a call stays
//     one launch with no float32 partials in device memory.  A split past
//     a lane's context loads nothing and joins the merge with l = 0; a
//     ctx = 0 lane's tiles are padding and come back as zeros.  A grid
//     that fills the card (long chunks, wide decode batches) keeps one
//     split and merges nothing.  Kernel 1, B.2 and their
//     head-feature route take the same plan for the same call, so B.2
//     with every flag clear and the head-feature route stay bit-equal to
//     kernel 1.  The partial mode keeps its own plan and float32 partials.
//
// float32: the CUDA-core body (paged_chunk_attention_kernel), as it was
// before the bf16 body moved to the tensor cores, bit for bit.  The H100's
// only float32 tensor-core product is TF32 (about three decimal digits), and
// the fp32 serving paths are held to exact tokens, so it keeps its float32
// FMAs.  One CTA of 128 threads owns one (lane, kv head, query tile) of
// kRows = 16 rows (bq = 16 / G positions), walks only the lane's relevant
// keys 32 a step, four threads loading each key's row with 16-byte loads one
// step ahead into registers, and stages the rows in shared memory as
// float32; the scores, the online softmax (one warp a row) and P.V
// (accumulators in registers) run on the CUDA cores.  At D = 80 and 96 a key
// row's int8 vectors split unevenly over the four loaders (5 and 6 over 4);
// at D = 80 the P.V accumulators cover 96 columns, of which the 16 pad
// columns read zeros and are never written (96 needs no pad).  It sits far
// from its operations bound and never splits a lane's keys in the unsplit
// entry (its fp32 serving paths are held to exact tokens): split-KV only
// in the partial mode, so a decode batch gives B x Hkv CTAs on 132 SMs.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "split_kv.cuh"

namespace cg = cooperative_groups;

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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// 16 bytes of float32 staged in smem
__device__ __forceinline__ void widen(const uint4& u, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
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

// -inf: the lse of a row that saw no key, and a masked score
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// The head-feature rung's pools (kFeat): shard r's K, V and int8 K and V
// pools, each (P, page, Hkv, dr) contiguous and 16-byte aligned (the int8
// ones null without kQuant), dr = 1 << ldr features a row.  With fp_tma
// (the caller's choice, taken only where dr = 8, pages hold a multiple of
// 8 rows and the K and V pools each lie at one stride, slices of one
// allocation as a card's shards get them) the bf16 body reads K and V by
// TMA into tiles of core matrices (see the producer); otherwise it gathers
// their rows by cp.async.  Passed by value as a __grid_constant__ kernel
// parameter (2 KB of the 4 KB limit); the other instantiations take the
// empty NoShards.
constexpr int kMaxShards = 64;
struct ShardPools {
  const void* k[kMaxShards];
  const void* v[kMaxShards];
  const void* kq[kMaxShards];
  const void* vq[kMaxShards];
  long long stride[2];  // bytes from a shard's K (V) pool to the next
                        // shard's; 0 where they differ
  int ldr;
  int tp;
  int fp_tma;           // K and V by TMA into core-matrix tiles
};
struct NoShards {};
__device__ __forceinline__ bool fp_tma(const ShardPools& sh) {
  return sh.fp_tma;
}
__device__ __forceinline__ bool fp_tma(const NoShards&) { return false; }
template <bool kFeat>
using ShardArg = std::conditional_t<kFeat, ShardPools, NoShards>;

// 16 bytes of a key row starting at byte column cb (a multiple of 16) of
// the row that the shards hold as runs of kE << ldr bytes (dr elements of
// kE bytes), each at element offset roff of its shard's pool: one 16-byte
// load from one shard, or whole runs of 8, 4 or 2 bytes from 16 / run
// consecutive shards
template <int kE>
__device__ __forceinline__ uint4 gather16(const void* const* pools,
                                          size_t roff, int cb, int ldr) {
  const int lrb = ldr + (kE == 4 ? 2 : kE == 2 ? 1 : 0);  // log2 run bytes
  const int r0 = cb >> lrb;
  if (lrb >= 4)
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const char*>(pools[r0]) + roff * kE +
        (cb & ((1 << lrb) - 1))));
  uint4 u;
  if (lrb == 3) {
    uint2* d = reinterpret_cast<uint2*>(&u);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      d[p] = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const char*>(pools[r0 + p]) + roff * kE));
  } else if (lrb == 2) {
    unsigned* d = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      d[p] = __ldg(reinterpret_cast<const unsigned*>(
          static_cast<const char*>(pools[r0 + p]) + roff * kE));
  } else {
    unsigned short* d = reinterpret_cast<unsigned short*>(&u);
#pragma unroll
    for (int p = 0; p < 8; ++p)
      d[p] = __ldg(reinterpret_cast<const unsigned short*>(
          static_cast<const char*>(pools[r0 + p]) + roff * kE));
  }
  return u;
}

// q (B, Sq, H, D); k/v pages (P, page, Hkv, D); tables (B, T) int32;
// q_offsets, ctx_lens (B,) int32; out (B, Sq, H, D).  kQuant adds the int8
// pools kq/vq (P, page, Hkv, D), the float32 scales (P,) and the int32
// flags (P,); without it they are null.  All contiguous, the pools 16-byte
// aligned.  kFeat: the pools are the shards' in `sh` (k_pages to vq_pages
// null), gathered into the same rows.
template <typename T, int D, bool kQuant, bool kFeat>
__global__ void __launch_bounds__(kThreads)
paged_chunk_attention_kernel(const __grid_constant__ ShardArg<kFeat> sh,
                             const T* __restrict__ q,
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
                             T* __restrict__ out, float* __restrict__ lse,
                             int Sq, int H, int Hkv, int page, int page_g,
                             int r_off, int T_width, int bq, int split,
                             int n_split) {
  constexpr int kTpr = kThreads / kRows;  // threads per row in P.V (8)
  // P.V columns padded to a multiple of 4 * kTpr (D = 80 -> 96); the pad
  // columns of v_s are zeros and are never written out
  constexpr int kDp = (D + 4 * kTpr - 1) / (4 * kTpr) * (4 * kTpr);
  constexpr int kCol4 = kDp / (4 * kTpr); // float4 accumulators per thread
  constexpr int kPerVec = 16 / sizeof(T); // elements per 16-byte load
  // a key row is kRowVecs 16-byte vectors (kRowVecsQ in int8); loader seg
  // takes vectors [seg * kVecs, seg * kVecs + kVecs) of them, the last
  // loader fewer where kSeg does not divide the row (D = 80 in int8)
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
  const int sp = blockIdx.x % n_split;     // the split of the shard's keys
  const int q0 = blockIdx.x / n_split * bq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // split sp's slot of the partials (the output itself without a split)
  out += (size_t)sp * gridDim.z * Sq * H * D;
  if (lse != nullptr) lse += (size_t)sp * gridDim.z * Sq * H;

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
    if (lse != nullptr)
      for (int r = tid; r < rows; r += kThreads)
        if (q0 + r / G < Sq)
          lse[((size_t)b * Sq + q0 + r / G) * H + h * G + r % G] = neg_inf();
    return;
  }
  const int q_last = min(q0 + bq, q_end) - 1;
  // relevant keys of this tile: up to the causal horizon of its last real
  // query (which is before the context's end); never past the table
  const int kv_end = min(qoff + q_last + 1, T_width * page_g);
  // the local keys (rows of this pool) before kv_end: kl = table entry *
  // page + row sits at position gpos(kl); all of them without a split
  const int n_local = kv_end / page_g * page +
                      min(max(kv_end % page_g - r_off, 0), page);
  auto gpos = [&](int kl) { return kl / page * page_g + r_off + kl % page; };
  // split sp walks the local keys [kl0, kl1) (a split is whole steps of
  // kKeys); a split past the tile's keys writes o = 0 and lse = -inf
  const int kl0 = sp * split;
  const int kl1 = n_split == 1 ? n_local : min(n_local, kl0 + split);

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
    const int kl = k0 + ld_j;
    row_q = false;
    if (kl < kl1) {
      const size_t pid = (size_t)table[kl / page];
      const size_t off = ((pid * page + kl % page) * Hkv + h) * D;
      if constexpr (kFeat) {
        // the row's tp runs, each at the row's offset in its shard's pool
        const size_t roff = ((pid * page + kl % page) * Hkv + h) << sh.ldr;
        const bool iq = kQuant && page_quant[pid];
        if (iq) {
          row_q = true;
          row_ks = k_scales[pid];
          row_vs = v_scales[pid];
        }
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {   // kVecsQ <= kVecs
          if (iq) {
            const int vi = seg * kVecsQ + v;
            if (v < kVecsQ && (kRowVecsQ % kSeg == 0 || vi < kRowVecsQ)) {
              k_reg[v] = gather16<1>(sh.kq, roff, vi * 16, sh.ldr);
              v_reg[v] = gather16<1>(sh.vq, roff, vi * 16, sh.ldr);
            }
          } else {
            const int vi = seg * kVecs + v;
            if (kRowVecs % kSeg == 0 || vi < kRowVecs) {
              k_reg[v] = gather16<sizeof(T)>(sh.k, roff, vi * 16, sh.ldr);
              v_reg[v] = gather16<sizeof(T)>(sh.v, roff, vi * 16, sh.ldr);
            }
          }
        }
        return;
      }
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

  if (kl0 < kl1) fetch(kl0);
  for (int k0 = kl0; k0 < kl1; k0 += kKeys) {
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
    if (k0 + kKeys < kl1) fetch(k0 + kKeys);  // in flight during the math
    // scores: a warp takes one row (kKeys == 32), a lane one key
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i % kKeys;
      const int qi = q0 + r / G;
      const int kl = k0 + j;
      float s = kMaskValue;
      if (r < rows && qi < q_end && kl < kl1 && gpos(kl) <= qoff + qi) {
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
      const int kl = k0 + lane;
      const bool valid = qi < q_end && kl < kl1 && gpos(kl) <= qoff + qi;
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
    if (lse != nullptr && pv_col == 0)
      lse[((size_t)b * Sq + qi) * H + h * G + r % G] =
          qi < q_end && l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : neg_inf();
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

// out: the output (B, Sq, H, D), or in the partial mode the float32
// partials (n_split, B, Sq, H, D) with lse (n_split, B, Sq, H)
template <int D, bool kQuant, bool kFeat>
cudaError_t launch(const ShardArg<kFeat>& sh, const void* q,
                   const void* k_pages, const void* v_pages,
                   const QuantArgs& qa, const int* tables,
                   const int* q_offsets, const int* ctx_lens, void* out,
                   float* lse, int B, int Sq, int H, int Hkv, int page,
                   int page_g, int r_off, int T_width, int split, int n_split,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  int bq = kRows / G;
  if (bq > Sq) bq = Sq;
  const long long nx = (long long)((Sq + bq - 1) / bq) * n_split;
  if (nx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)nx, Hkv, B);
  paged_chunk_attention_kernel<float, D, kQuant, kFeat>
      <<<grid, kThreads, 0, stream>>>(
      sh, static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), qa.kq_pages, qa.vq_pages,
      qa.k_scales, qa.v_scales, qa.page_quant, tables, q_offsets, ctx_lens,
      static_cast<float*>(out), lse, Sq, H, Hkv, page, page_g, r_off, T_width,
      bq, split, n_split);
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
// the head-feature rung's producer warps (kFeat): the cp.async gather's
// rows alternate between them
constexpr int kFeatProducers = 2;
// B.2's warps that turn flagged pages' codes into bf16 tiles, producer
// warps kCvtFirst to kCvtFirst + kCvtWarps - 1 (warp 4 is the producer):
// see the producer
constexpr int kCvtFirst = 1;
constexpr int kCvtWarps = 3;
// B.2's registers a thread: 256 threads and two CTAs an SM leave 128 at
// launch; the producer warpgroup gives back down to kCvtProdRegs
// (setmaxnreg), the consumers take kCvtConsRegs, 128 x (168 + 88) = the
// CTA's 256 x 128 (the converters hold one unit at a time)
constexpr int kCvtLaunchRegs = 128;
constexpr int kCvtConsRegs = 168;
constexpr int kCvtProdRegs = 88;
static_assert(kCvtConsRegs + kCvtProdRegs == 2 * kCvtLaunchRegs,
              "the two warpgroups share the CTA's registers");
// warps beside the consumer warpgroup
template <bool kFeat, bool kQuant>
constexpr int kTcProducers =
    kFeat ? kFeatProducers : kQuant ? kCvtFirst + kCvtWarps : 1;
// threads a CTA: a consumer warpgroup and the producer warp(s)
template <bool kFeat, bool kQuant>
constexpr int kTcThreads = 128 + 32 * kTcProducers<kFeat, kQuant>;
constexpr int kMaxPages = kTcKeys;             // pages a stage, at 1 row
// CTAs of a cluster over which the unsplit entry splits a lane's keys (the
// portable cluster size; no non-portable attribute is set), the wrapper's
// paged_attention.CHUNK_MAX_SPLITS
constexpr int kMaxCluster = 8;

// a box of a 4D tensor map into shared memory, completing on bar (the
// head-feature rung's maps over every shard's pool: see feat_map)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of an operand in core matrices (8 rows of
// 16 bytes, 128 contiguous bytes each), no swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major: lbo steps along K,
// sbo along M / N; MN-major: lbo along K, sbo along M / N
__device__ __forceinline__ uint64_t core_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// A copy of 16, 8 or 4 bytes (2^lb) by cp.async, or of 2 (codes of dr = 2
// features: an ordinary load and store, which the consumers read as such)
__device__ __forceinline__ void feat_copy(uint8_t* dst, const char* src,
                                          int lb) {
  const uint32_t d = smem_u32(dst);
  if (lb == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (lb == 3)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (lb == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
}

// The head-feature rung's copies that one producer lane makes of every key
// row, fixed for the CTA.  A bf16 row's D columns are nu = 2 D / 2^lub
// copies of 2^lub = min(2 dr, 16) bytes, copy u being byte columns [u
// 2^lub, (u + 1) 2^lub): features e = u 2^lub / 2 on of shard e / dr, at
// feature e % dr of its row.  The copies are padded to 2^lu slots (nu >=
// 8), lane l taking slot l % 2^lu (and l + 32 when 2^lu = 64) of keys l /
// 2^lu + kstep i, kstep = 32 / 2^lu keys (1 past 32 slots), producer warp
// w the iterations i = w, w + kFeatProducers, ....  A flagged
// page's codes are nc = D / 2^lcb copies of 2^lcb = min(dr, 16) bytes,
// slotted the same way.  Columns past D (D = 80, 96) are not copied: no
// product reads them.
struct FeatSlots {
  const char* k[2];
  const char* v[2];
  const char* kq[2];
  const char* vq[2];
  uint32_t col[2], chunk[2], ccol[2];
  bool on[2], con[2];
  int ldr, lub, lcb, j0, kstep, cj0, ckstep;

  template <int D>
  __device__ __forceinline__ void init(const ShardPools& sh, int lane) {
    ldr = sh.ldr;
    lub = min(4, ldr + 1);
    lcb = min(4, ldr);
    const int nu = 2 * D >> lub, lu = 32 - __clz(nu - 1);
    const int nc = D >> lcb, lc = 32 - __clz(nc - 1);
    j0 = lu < 5 ? lane >> lu : 0;
    kstep = lu < 5 ? 32 >> lu : 1;
    cj0 = lc < 5 ? lane >> lc : 0;
    ckstep = lc < 5 ? 32 >> lc : 1;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int u = (lu < 5 ? lane & ((1 << lu) - 1) : lane) + 32 * c;
      on[c] = u < nu && (c == 0 || lu > 5);
      const int cb = on[c] ? u << lub : 0, e = cb >> 1;
      const int w = 2 * (e & ((1 << ldr) - 1));   // bytes into the run
      k[c] = static_cast<const char*>(sh.k[e >> ldr]) + w;
      v[c] = static_cast<const char*>(sh.v[e >> ldr]) + w;
      col[c] = (cb >> 7) * kTcKeys * 128 + (cb & 15);
      chunk[c] = (cb >> 4) & 7;
      const int uc = (lc < 5 ? lane & ((1 << lc) - 1) : lane) + 32 * c;
      con[c] = uc < nc && (c == 0 || lc > 5);
      const int cc = con[c] ? uc << lcb : 0;
      kq[c] = static_cast<const char*>(sh.kq[cc >> ldr]) +
              (cc & ((1 << ldr) - 1));
      vq[c] = static_cast<const char*>(sh.vq[cc >> ldr]) +
              (cc & ((1 << ldr) - 1));
      ccol[c] = cc;
    }
  }
};

// what the producer tells the consumers about a stage of the int8 kernel:
// which of its pages come from the int8 pools (bit i: page i of the
// stage), and their scales.  Only 1-row pages fill more than 32 entries
// and the mask's high word
struct StageMeta {
  float ks[kMaxPages];
  float vs[kMaxPages];
  unsigned long long mask;
};

// Byte offsets in the 1024-byte-aligned dynamic shared memory.  Each bf16
// tile is stored as kCb 64-column blocks of [rows][128 bytes], 128-byte
// swizzled: the 16-byte chunk c of row r sits at chunk c ^ (r % 8), as TMA
// writes it and as wgmma's SWIZZLE_128B descriptors read it.  On the
// head-feature rung an int8 page's codes land, unswizzled, [page rows][D]
// bytes, in the page's own rows of the tile's last column block (page * 128
// >= page * D bytes), and are converted there in place; B.2's converter
// warps write the bf16 rows themselves.
template <int D, bool kQuant, bool kCvt = false>
struct PcSmem {
  static constexpr int kCb = (D + 63) / 64;                // column blocks
  static constexpr int kQ = 0;
  static constexpr int kStage = kTcKeys * kCb * 128;       // one K or V tile
  static constexpr int kK = kTcRows * kCb * 128;
  static constexpr int kV = kK + kTcStages * kStage;
  static constexpr int kCodes = (kCb - 1) * kTcKeys * 128; // codes in a tile
  // kCvt: the codes of one stage's flagged pages, K then V, page i's
  // [page rows][D] bytes at i * page * 128 (TMA lands a box at a multiple
  // of 128 bytes)
  static constexpr int kStaging = kV + kTcStages * kStage;
  static constexpr int kMeta = kStaging + (kCvt ? 2 * kTcKeys * 128 : 0);
  static constexpr int kBars =
      kMeta + (kQuant ? kTcStages * (int)sizeof(StageMeta) : 0);
  // full and empty barriers a stage, then (kCvt) the staging's landed and
  // free barriers
  static constexpr int kBytes = kBars + 2 * kTcStages * 8 + 16;
  static constexpr int kAlloc = kBytes + 1024;             // alignment slack
  static_assert(kBars % 8 == 0, "mbarriers are 8-byte aligned");
  // a cluster's merge: each consumer thread's (o[D / 2], m[2], l[2]) over
  // the K and V rings, once the ring is drained
  static_assert((D / 2 + 4) * 128 * 4 <= 2 * kTcStages * kStage,
                "the merge's slots fit in the ring");
};

// 16 int8 codes as 16 bf16 values (two 16-byte chunks), exact for |code|
// <= 128: byte u = code + 128 set into the mantissa of 2^23 gives the
// float 2^23 + u, minus 2^23 + 128 the code itself, whose top 16 bits are
// its bf16 (a whole number of at most 8 bits has no lower mantissa bits).
// Two byte permutes and an add a code, no conversion instruction: the same
// bits as __floats2bfloat162_rn((float)code, ...)
__device__ __forceinline__ void codes_to_bf16(const uint4& c, uint4& lo,
                                              uint4& hi) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t out[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = w[k] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + e)) -
             8388736.f;
    out[2 * k] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                             0x7632);
    out[2 * k + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]),
                                 0x7632);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// q, out (B, Sq, H, D) bf16, contiguous; the K and V pools (P, page, Hkv,
// D) through kmap / vmap (bf16) and, with kQuant, their int8 shadows
// through kqmap / vqmap (codes, into the staging), with the scales (P,)
// float32 and flags (P,) int32; tables (B, T_width), q_offsets and
// ctx_lens (B,) int32.  Grid: one CTA per (query tile, split, kv head,
// lane), the highest query tiles first.  n_clu > 1 (the unsplit entry on a
// small grid): the n_split = n_clu splits of one (query tile, kv head,
// lane) are the consecutive CTAs of one cluster, merged over distributed
// shared memory into `out` (see the epilogue).
// kOneRow: pages of 1 row (split-K shard pages only), where each of a
// quad thread's two keys of a fragment has a page, a position and an int8
// flag of its own, and a stage spans 64 pages.  With pages of 2 rows or
// more the two keys share a page, so the softmax looks up one position
// and one flag a key pair, a stage's pages fit a 32-bit mask, and the
// producer reads its table entries once a 32-page window: the unsplit
// kernel runs that body (one body for every page size, with per-key
// lookups and per-stage entry reads, made the unsplit B.2 ~18 % slower on
// the same calls).  kFeat: the head-feature rung's pools (`sh`; k_pool /
// v_pool unused, kmap / vmap its feat_map boxes where it reads by TMA),
// each row's D columns from tp shards, two producer warps (see the
// producer).
template <int D, bool kQuant, bool kOneRow, bool kFeat>
__global__ void __launch_bounds__(kTcThreads<kFeat, kQuant>, kTcCtasPerSm)
paged_chunk_attention_tc(const __grid_constant__ ShardArg<kFeat> sh,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap kqmap,
               const __grid_constant__ CUtensorMap vqmap,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pool,
               const __nv_bfloat16* __restrict__ v_pool,
               const float* __restrict__ k_scales,
               const float* __restrict__ v_scales,
               const int* __restrict__ page_quant,
               const int* __restrict__ tables,
               const int* __restrict__ q_offsets,
               const int* __restrict__ ctx_lens,
               __nv_bfloat16* __restrict__ out, float* __restrict__ part,
               float* __restrict__ lse, int B, int Sq, int H, int Hkv,
               int page, int page_g, int r_off, int T_width, int bq,
               int n_qblk, int split, int n_split, int n_clu) {
  // B.2 off the head-feature rung: flagged pages' codes come from the int8
  // pools through the converter warps, never into the tile as codes
  constexpr bool kCvt = kQuant && !kFeat;
  using L = PcSmem<D, kQuant, kCvt>;
  constexpr int kThr = kTcThreads<kFeat, kQuant>;
  using Mask = std::conditional_t<kOneRow, unsigned long long, unsigned>;
  constexpr int kCb = L::kCb;
  constexpr int kChunks = D / 8;              // 16-byte bf16 chunks a row
  constexpr int kUnits = D / 16;              // 16-code int8 units a row
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + L::kBars;     // full[s], then empty[s]
  const uint32_t empty0 = full0 + 8 * kTcStages;
  const uint32_t landed = empty0 + 8 * kTcStages;  // kCvt: the staging's
  const uint32_t freed = landed + 8;                // codes in, read
  StageMeta* meta = reinterpret_cast<StageMeta*>(smem + L::kMeta);

  const int G = H / Hkv;
  const int rows = bq * G;
  // the merge mode: this CTA is rank sp of its (tile, kv head, lane)'s
  // cluster, the ranks consecutive; otherwise the splits of one tile lie
  // Hkv * B CTAs apart
  const bool merge = n_clu > 1;
  const int cl = merge ? blockIdx.x / n_clu : blockIdx.x;
  const int hb = cl % (Hkv * B);
  const int h = hb % Hkv, b = hb / Hkv;
  const int sq = cl / (Hkv * B);
  const int sp = merge ? blockIdx.x % n_clu : sq % n_split;  // the split
  const int q0 = (n_qblk - 1 - (merge ? sq : sq / n_split)) * bq;
  const int ctx = ctx_lens[b];
  const int qoff = q_offsets[b];
  // split sp's slot of the float32 partials (partial mode only)
  if (part != nullptr) {
    part += (size_t)sp * B * Sq * H * D;
    lse += (size_t)sp * B * Sq * H;
  }
  // the lane's real query rows: its chunk ends at the context's end, so a
  // row at qpos >= ctx is bucket padding (all rows of a ctx = 0 lane)
  const int q_end = ctx > 0 ? max(0, min(Sq, ctx - qoff)) : 0;
  const int q_last = min(q0 + bq, q_end) - 1;
  // relevant keys of this tile: up to the causal horizon of its last real
  // query (which is before the context's end); never past the table
  const int kv_end = min(qoff + q_last + 1, T_width * page_g);
  const int n_pages = (kv_end + page_g - 1) / page_g;  // relevant entries
  // split sp takes the tile's local keys [kl0, kl1) of the n_pages * page
  // its entries hold: whole 64-key stages t0 .. t1 - 1
  const int kl0 = sp * split;
  const int kl1 = n_split == 1 ? n_pages * page
                               : min(n_pages * page, kl0 + split);
  // a split past the tile's keys: in the merge mode it still joins its
  // cluster's merge (with l = 0), since every CTA of a cluster takes part
  const bool idle = kl0 >= kl1;
  if (q0 >= q_end || (idle && !merge)) {
    // a tile of padding rows (the same for every CTA of a cluster), or a
    // split past the tile's keys: zeros (and lse -inf), no K/V read
    if (merge && sp != 0) return;
    if (part == nullptr) {
      for (int i = threadIdx.x; i < rows * kChunks; i += kThr) {
        const int r = i / kChunks, qi = q0 + r / G;
        if (qi < Sq)
          reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * H + h * G +
                                          r % G) * D)[i % kChunks] =
              make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = threadIdx.x; i < rows * (D / 4); i += kThr) {
        const int r = i / (D / 4), qi = q0 + r / G;
        if (qi < Sq)
          reinterpret_cast<float4*>(part + (((size_t)b * Sq + qi) * H +
                                            h * G + r % G) * D)[i % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = threadIdx.x; r < rows; r += kThr)
        if (q0 + r / G < Sq)
          lse[((size_t)b * Sq + q0 + r / G) * H + h * G + r % G] = neg_inf();
    }
    return;
  }
  const int t0 = kl0 / kTcKeys;
  const int t1 = idle ? t0 : (kl1 + kTcKeys - 1) / kTcKeys;
  const int lp = kOneRow ? 0 : __ffs(page) - 1;  // log2(page)
  const int ppt = kTcKeys >> lp;              // pages a stage
  // position of the local key kl (row kl % page of table entry kl / page);
  // kl itself without a split
  auto gpos = [&](int kl) {
    if constexpr (kOneRow) return kl * page_g + r_off;
    else return (kl >> lp) * page_g + r_off + (kl & (page - 1));
  };

  // kFeat by TMA: the K and V tiles are core matrices (see the producer)
  const bool cm = kFeat && fp_tma(sh);
  // zero the rows of the last tile's stage that no load fills (keys past
  // the lane's relevant pages), so that no garbage meets p = 0
  if (idle) {
    // no stage: nothing to zero
  } else if (cm) {                            // rows [filled, 64): one span
    const int t = t1 - 1;
    const int filled = min(kTcKeys, n_pages * page - t * kTcKeys);
    const int n = (kTcKeys - filled) * D / 8;  // 16-byte chunks a side
    const uint32_t st = ((t - t0) % kTcStages) * L::kStage + filled * D * 2;
    for (int i = threadIdx.x; i < 2 * n; i += kThr)
      *reinterpret_cast<uint4*>(smem + (i / n ? L::kV : L::kK) + st +
                                (i % n) * 16) = make_uint4(0, 0, 0, 0);
  } else {
    const int t = t1 - 1;
    const int filled = min(kTcKeys, n_pages * page - t * kTcKeys);
    const int n = (kTcKeys - filled) * 8;     // 16-byte chunks a block
    const uint32_t st = ((t - t0) % kTcStages) * L::kStage + filled * 128;
    for (int i = threadIdx.x; i < 2 * kCb * n; i += kThr) {
      const int kv = i / (kCb * n), rem = i % (kCb * n);
      *reinterpret_cast<uint4*>(smem + (kv ? L::kV : L::kK) + st +
                                (rem / n) * kTcKeys * 128 + (rem % n) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      // kFeat: each producer warp; kCvt: the producer's expect_tx, then
      // each converter warp once its bf16 rows are stored
      mbar_init(full0 + 8 * s, kFeat ? kFeatProducers : kCvt ? 1 + kCvtWarps
                                                             : 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    mbar_init(landed, 1);
    mbar_init(freed, kCvtWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros are generic-proxy stores that TMA (the async proxy) may later
  // overwrite: order them first
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4) {
    const int pw = warp - 4;                  // producer warp (kFeat: 0, 1)
    // kCvt: the producer warpgroup (the producer and the converters) gives
    // registers back to the consumers
    if constexpr (kCvt)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kCvtProdRegs));
    // the producer warp.  Lane i holds the table entries (with kQuant the
    // int8 flags and scales) of pages w0 + i and, at 1-row pages, w0 + 32
    // + i of a window of kWin pages of the lane's table row, read once a
    // window and before the wait for the stage's slot, so that their
    // latency overlaps the consumers' work.  A stage (64 / page pages)
    // never straddles two windows: 64 / page divides 32 for page >= 2, and
    // is the window at 1 row.  Each lane writes its own pages' scales into
    // the stage's StageMeta and issues its own pages' loads.  Pages of 4
    // rows or more go by TMA, one box a page, kv head and 64-column block.
    // Shard pages of 1 or 2 rows (the split-K partial mode) are gathered
    // by cp.async instead: a stage of them is 128 or 256 TMA boxes of one
    // or two rows, and the TMA unit's issue of that many boxes set each
    // stage's time (chip_smoke.py phase 21 on an H100 SXM: the shards'
    // device time was 1.35x at 1-row pages what it was at 2-row pages on
    // the same calls, and 1.0x with the gather).  The 32 lanes copy the
    // stage's rows 16 bytes a lane, K and V, into the 128-byte swizzle
    // that TMA writes (chunk c of row j at c ^ (j % 8)), zero-filling the
    // columns past D, so the tile and the wgmma descriptors are the same
    // either way.  Each lane waits for its own copies and fences them for
    // the async proxy (wgmma) before the warp syncs and lane 0 arrives on
    // the stage's full barrier.
    //
    // kCvt (B.2 off the head-feature rung): warp 4 is kernel 1's producer
    // for the fp pages (and writes StageMeta), and also fetches each
    // flagged stage's codes by TMA into the staging buffer (fetch_codes)
    // once the converters have freed it; warps 5-7, the converters, each
    // hold the window too.  Converter thread c (lane + 32 (pw - 1)) takes
    // the 16-code units c, c + 96, ... of the stage's 64 keys x D / 16
    // units (one key's units on neighbouring lanes, K and V alike) and
    // writes each as bf16 (codes_to_bf16) into the swizzled rows; its warp
    // fences them for the async proxy, frees the staging and arrives on
    // the full barrier, whose count is the producer's expect_tx and the
    // three converters.
    //
    // kFeat (the head-feature rung) has two producer warps and two ways
    // to fill a stage.  A row's D columns are tp runs of dr features, run
    // r in shard r's pool at the same (page, row, kv head), 16 bytes or
    // less apart from the next kv head's at yi-6b's dr = 8: a stage is
    // 2048 such runs.
    //   * TMA (fp_tma, the caller's choice, open where dr = 8, pages hold
    //     a multiple of 8 rows and each side's pools lie at one stride):
    //     one 4D box (feat_map) a side and
    //     8-row group of a page takes every shard's 8 features of those
    //     rows and lands them as tp core matrices (8 rows x 16 bytes), so
    //     the K and V tiles are core matrices, group g of rows at g D 16
    //     bytes, chunk f of 8 features at 128 f within it, and the
    //     consumers read them by no-swizzle descriptors (core_desc): 16
    //     boxes a stage against the 32 swizzled boxes of the unsharded
    //     kernel, whose 16-byte pieces the TMA unit fetches one by one.
    //   * cp.async otherwise: the lanes copy the runs (or 16-byte parts of
    //     them) into the 128-byte swizzle TMA gives the unsharded kernel,
    //     each lane its fixed slots of every row (FeatSlots), the two warps
    //     alternating rows.  Columns past D (D = 80, 96) are not copied: no
    //     product reads them.
    // A flagged page's codes are always gathered (dr codes of a row are
    // under TMA's 16-byte minimum at dr = 8), into the rows where the
    // unsharded kernel's box lands them, or in core-matrix tiles into the
    // upper half of their 8-row group's span.  The lanes do not wait for
    // their copies: each lane's cp.async.mbarrier.arrive makes the stage's
    // full barrier wait for them, the warps go on to the next stage at
    // once, and the consumers fence the landed rows for wgmma.  Either
    // way the tile holds the unsharded kernel's values, so its output is
    // bit-equal to the kernel's on the shards' pools concatenated along D.
    // A producer warp that waited for each stage's copies before the
    // next kept one stage's loads in flight; arriving by cp.async and a
    // second warp keep both stages loading.  On chip_smoke.py phase 21's
    // calls, which it times through both producers, TMA is faster at
    // decode and at least even with the gather at chunks: the wrapper
    // takes it wherever it is open (paged_attention.features_producer).
    const int* row = tables + (size_t)b * T_width;
    // fp rows copied by cp.async (else TMA boxes); the head-feature rung's
    // int8 codes always (a shard's codes of a row, dr bytes, are under
    // TMA's 16-byte minimum at the dr = 8 of its TMA path)
    const bool gather = kFeat ? !cm : page <= 2;
    constexpr bool gather_codes = kFeat;
    constexpr int kPer = kOneRow ? 2 : 1;     // table entries a lane holds
    constexpr int kWin = 32 * kPer;           // pages a window
    constexpr int kRowChunks = kCb * 8;       // 16-byte chunks a tile row
    int pid[kPer] = {};
    bool qf[kPer] = {};
    float ksv[kPer] = {}, vsv[kPer] = {};
    Mask win = 0;                             // the window's int8 flags
    FeatSlots fs;
    if constexpr (kFeat) fs.init<D>(sh, lane);
    // stage t's pages (np from the window slot l0) and int8 mask, set by
    // window(t) at the end of the iteration before (the table entries,
    // flags and scales are read once a window, before the wait for the
    // stage's slot, so that their latency overlaps the consumers' work)
    int np = 0, l0 = 0;
    Mask mask = 0;
    auto window = [&](int t) {
      const int p0 = t * ppt;
      np = min(ppt, n_pages - p0);            // relevant pages of stage t
      l0 = p0 % kWin;                         // its first page's slot
      if (l0 == 0 || t == t0) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int p = p0 - l0 + lane + 32 * j;
          pid[j] = p < n_pages ? row[p] : 0;
          if constexpr (kQuant) {
            qf[j] = p < n_pages && page_quant[pid[j]] != 0;
            if (qf[j] && pw == 0) {           // StageMeta's writer
              ksv[j] = k_scales[pid[j]];
              vsv[j] = v_scales[pid[j]];
            }
          }
        }
        if constexpr (kQuant) {
          win = __ballot_sync(0xffffffffu, qf[0]);
          if constexpr (kOneRow)
            win |= (Mask)__ballot_sync(0xffffffffu, qf[kPer - 1]) << 32;
        }
      }
      if constexpr (kQuant)
        mask = win >> l0 & (~Mask(0) >> (8 * (int)sizeof(Mask) - np));
    };
    if (kCvt && pw >= kCvtFirst) {
      // A converter warp.  Per stage with a flagged page: wait for its
      // codes in the staging and for the stage's slot, then turn this
      // thread's 16-code units (K and V) one at a time into bf16 chunks 2u
      // and 2u + 1 of key j's row, in the swizzle TMA writes (the columns
      // past D at D = 80 and 96 are left as they are: no product reads
      // them), fenced for wgmma, and free the staging (the producer then
      // fetches the next flagged stage's codes, ahead of the ring's slot).
      // Every stage, its warp arrives on the full barrier.
      const uint8_t* stg = smem + L::kStaging;
      unsigned ph = 0;                        // flagged stages seen
      if (t0 < t1) window(t0);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % kTcStages;
        const Mask smask = mask;
        const int n_rows = np * page;
        if (t + 1 < t1) window(t + 1);
        if (smask) mbar_wait(landed, ph++ & 1);
        if (i >= kTcStages)
          mbar_wait(empty0 + 8 * s, (i / kTcStages - 1) & 1);
        if (smask) {
          uint8_t* kt = smem + L::kK + s * L::kStage;
          uint8_t* vt = smem + L::kV + s * L::kStage;
#pragma unroll 2
          for (int ku = (pw - kCvtFirst) * 32 + lane; ku < kTcKeys * kUnits;
               ku += 32 * kCvtWarps) {
            const int j = ku / kUnits, u = ku - j * kUnits;
            if (j >= n_rows || !(smask >> (j >> lp) & 1)) continue;
            const int at =
                (j >> lp) * page * 128 + (j & (page - 1)) * D + u * 16;
#pragma unroll
            for (int kv = 0; kv < 2; ++kv) {
              uint4 half[2];
              codes_to_bf16(*reinterpret_cast<const uint4*>(
                                stg + kv * kTcKeys * 128 + at),
                            half[0], half[1]);
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int ch = 2 * u + hf;
                *reinterpret_cast<uint4*>(
                    (kv ? vt : kt) + (ch / 8) * kTcKeys * 128 + j * 128 +
                    (((ch % 8) ^ (j % 8)) * 16)) = half[hf];
              }
            }
          }
          // the rows for wgmma (the async proxy), before the warp arrives
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(freed);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * s);
      }
      if (merge) {                            // the consumers' merge
        cg::this_cluster().sync();
        cg::this_cluster().sync();
      }
      return;
    }
    // kCvt: the flagged pages' codes of the stage whose window was just
    // read, into the staging once the converters are done with the last
    // flagged stage's (a stage or more ahead of the ring's slots)
    unsigned nfl = 0;                         // flagged stages fetched
    auto fetch_codes = [&]() {
      if (!kCvt || !mask) return;
      if (nfl > 0) mbar_wait(freed, (nfl - 1) & 1);
      ++nfl;
      if (lane == 0)
        mbar_expect_tx(landed,
                       __popcll((unsigned long long)mask) * 2 * page * D);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int pi = lane + 32 * j - l0;
        if (pi < 0 || pi >= np || !qf[j]) continue;
        const uint32_t off = pi * page * 128;
        tma_load_3d(base + L::kStaging + off, &kqmap, landed, 0, h,
                    pid[j] * page);
        tma_load_3d(base + L::kStaging + kTcKeys * 128 + off, &vqmap, landed,
                    0, h, pid[j] * page);
      }
      __syncwarp();
    };
    if (t0 < t1) {
      window(t0);
      fetch_codes();
    }
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % kTcStages;
      if (i >= kTcStages)
        mbar_wait(empty0 + 8 * s, (i / kTcStages - 1) & 1);
      if constexpr (kQuant) {
        // each lane writes its pages' scales; the warp syncs before lane 0
        // arrives, so the consumers see them once the stage is full
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int pi = lane + 32 * j - l0;  // its page of the stage
          if (pw == 0 && qf[j] && pi >= 0 && pi < np) {
            meta[s].ks[pi] = ksv[j];
            meta[s].vs[pi] = vsv[j];
          }
        }
        if (pw == 0 && lane == 0) meta[s].mask = mask;
      }
      const int nq = __popcll((unsigned long long)mask);
      if ((gather || gather_codes) && (kFeat || pw == 0)) {
        // the stage's np * page rows (keys), K then V, chunk idx % kRowChunks
        // of row idx / kRowChunks for idx = lane, lane + 32, ...; at 1 or 2
        // rows a stage is a whole window (l0 = 0), and the rows of one pass
        // lie in pages of one half of it, so every lane reads the same pid
        // register of the lane that holds its page
        const int n_rows = np * page;
        uint8_t* kt = smem + L::kK + s * L::kStage;
        uint8_t* vt = smem + L::kV + s * L::kStage;
        if constexpr (kFeat) {
          // every key row of the stage's relevant pages (its fp pages'
          // rows, then a flagged page's codes), each lane its fixed copy
          // slots of the rows j0, j0 + fs.kstep, ...; the key's page sits
          // at slot l0 + pi of the window, and the keys of one iteration
          // (at most 4) lie in one half of it
          const int it_n = gather ? kTcKeys / fs.kstep : 0;
          for (int it = pw; it < it_n; it += kFeatProducers) {
            const int j = fs.j0 + it * fs.kstep;
            const int pi = j >> lp;
            const int src = __shfl_sync(
                0xffffffffu,
                (it * fs.kstep >> lp) + l0 >= 32 ? pid[kPer - 1] : pid[0],
                (pi + l0) & 31);
            if (j >= n_rows || (kQuant && (mask >> pi & 1))) continue;
            const size_t roff =
                (((size_t)src * page + (j & (page - 1))) * Hkv + h) << fs.ldr;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if (!fs.on[c]) continue;
              const uint32_t dst = fs.col[c] + j * 128 +
                                   ((fs.chunk[c] ^ (j & 7)) << 4);
              feat_copy(kt + dst, fs.k[c] + 2 * roff, fs.lub);
              feat_copy(vt + dst, fs.v[c] + 2 * roff, fs.lub);
            }
          }
          if (kQuant && mask && gather_codes) {
            // the flagged pages' codes, [page rows][D] bytes at the page's
            // rows of the last column block, as their TMA box lands
            const int itc = kTcKeys / fs.ckstep;
            for (int it = pw; it < itc; it += kFeatProducers) {
              const int j = fs.cj0 + it * fs.ckstep;
              const int pi = j >> lp;
              const int src = __shfl_sync(
                  0xffffffffu,
                  (it * fs.ckstep >> lp) + l0 >= 32 ? pid[kPer - 1] : pid[0],
                  (pi + l0) & 31);
              if (j >= n_rows || !(mask >> pi & 1)) continue;
              const size_t roff =
                  (((size_t)src * page + (j & (page - 1))) * Hkv + h)
                  << fs.ldr;
              const uint32_t dst0 =
                  cm ? (j >> 3) * D * 16 + D * 8 + (j & 7) * D
                     : L::kCodes + pi * page * 128 + (j & (page - 1)) * D;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                if (!fs.con[c]) continue;
                feat_copy(kt + dst0 + fs.ccol[c], fs.kq[c] + roff, fs.lcb);
                feat_copy(vt + dst0 + fs.ccol[c], fs.vq[c] + roff, fs.lcb);
              }
            }
          }
          // the lane's copies arrive on the stage's full barrier when they
          // land (its pending count rises here and falls then), so the
          // warp goes on to the next stage without waiting for them; the
          // consumers fence the landed rows for wgmma
          asm volatile(
              "cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                  full0 + 8 * s)
              : "memory");
        } else {
#pragma unroll 4
          for (int idx = lane; idx < kTcKeys * kRowChunks; idx += 32) {
            const int j = idx / kRowChunks, c = idx % kRowChunks;
            const int pi = j >> lp;
            const int src = __shfl_sync(0xffffffffu,
                                        (idx - lane) / kRowChunks >> lp >= 32
                                            ? pid[kPer - 1] : pid[0],
                                        pi & 31);
            if (j >= n_rows || (kQuant && (mask >> pi & 1))) continue;
            const size_t off =
                (((size_t)src * page + (j & (page - 1))) * Hkv + h) * D;
            const bool in = c < kChunks;      // zeros past column D
            const uint32_t dst = (c / 8) * kTcKeys * 128 + j * 128 +
                                 (((c % 8) ^ (j % 8)) * 16);
            cp_async16(kt + dst, k_pool + off + (in ? 8 * c : 0), in);
            cp_async16(vt + dst, v_pool + off + (in ? 8 * c : 0), in);
          }
          cp_async_commit();
          cp_async_wait<0>();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      }
      __syncwarp();                           // scales and copies before
      if (lane == 0 && (kFeat || pw == 0))    // the arrive: the fp pages'
        mbar_expect_tx(full0 + 8 * s,         // TMA bytes
                       pw != 0 || gather ? 0
                       : cm ? (np - nq) * 4 * page * D
                            : (np - nq) * 2 * kCb * page * 128);
      __syncwarp();                           // the count before any bytes
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int pi = lane + 32 * j - l0;
        if (pw != 0 || pi < 0 || pi >= np) continue;
        const int krow = pid[j] * page;
        if (kQuant && qf[j]) {
          continue;              // codes: the staging's (kCvt), or gathered
        } else if (!gather) {
          if constexpr (kFeat) {
            // each 8-row group of the page: one box of every shard's 8
            // features of its rows, landing as tp core matrices in order
            for (int g = 0; g < page; g += 8) {
              const uint32_t off =
                  s * L::kStage + (pi * page + g) * D * 2;
              tma_load_4d(base + L::kK + off, &kmap, full0 + 8 * s, 0, h,
                          krow + g, 0);
              tma_load_4d(base + L::kV + off, &vmap, full0 + 8 * s, 0, h,
                          krow + g, 0);
            }
          } else {
#pragma unroll
            for (int c = 0; c < kCb; ++c) {
              const uint32_t off =
                  s * L::kStage + c * kTcKeys * 128 + pi * page * 128;
              tma_load_3d(base + L::kK + off, &kmap, full0 + 8 * s, 64 * c,
                          h, krow);
              tma_load_3d(base + L::kV + off, &vmap, full0 + 8 * s, 64 * c,
                          h, krow);
            }
          }
        }
      }
      __syncwarp();
      // the next stage's pages and flags (kCvt: and its codes)
      if (t + 1 < t1) {
        window(t + 1);
        fetch_codes();
      }
    }
    // kFeat: no lane leaves with copies in flight
    if constexpr (kFeat) asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (merge) {                              // the consumers' merge
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  if constexpr (kCvt)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kCvtConsRegs));
  // the consumer warpgroup: stage the tile's query rows, swizzled (zeros
  // for padding rows and past D), then make the generic-proxy stores
  // visible to wgmma
  for (int i = threadIdx.x; i < kTcRows * kCb * 8; i += 128) {
    const int r = i / (kCb * 8), c = i % (kCb * 8);
    const int qi = q0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < kChunks && r < rows && qi < q_end)
      val = __ldg(reinterpret_cast<const uint4*>(
                q + (((size_t)b * Sq + qi) * H + h * G + r % G) * D) + c);
    *reinterpret_cast<uint4*>(smem + L::kQ + (c / 8) * kTcRows * 128 +
                              r * 128 + (((c % 8) ^ (r % 8)) * 16)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  const int g = lane / 4, tq = lane % 4;       // row group, thread in quad
  const int r0 = warp * 16 + g;                // rows r0 and r0 + 8
  const int lim = kv_end - 1;                  // the last relevant key
  int hz[2];            // the last key each row sees; -1: a padding row
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 8 * j, qi = q0 + r / G;
    hz[j] = (r < rows && qi < q_end) ? min(qoff + qi, lim) : -1;
  }
  const int first = min(qoff + q0, lim);       // row 0's horizon; row 0 is real

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e)/sqrt(D)

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) % kTcStages;
    const int k0 = t * kTcKeys;
    mbar_wait(full0 + 8 * s, ((t - t0) / kTcStages) & 1);
    // kFeat: the rows landed by cp.async (generic-proxy writes, seen
    // through the barrier), fenced before wgmma (the async proxy) reads
    if constexpr (kFeat)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    Mask mask = 0;
    if constexpr (kQuant) mask = (Mask)meta[s].mask;
    if constexpr (kFeat && kQuant) {
      if (mask) {
        // the head-feature rung: the flagged pages' codes (gathered into
        // the tile) to bf16 in place, K then V, 32 keys (whole pages, whose
        // codes lie in their own rows) a pass: every thread
        // reads its share of the pass's codes, the warpgroup syncs, then
        // each writes its bf16 chunks into the tile (at D = 80 the columns
        // past 80 keep code bytes, which neither product reads)
        constexpr int kPass = kTcKeys / 2;
        constexpr int kPer = (kPass * kUnits + 127) / 128;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          uint8_t* tile = smem + (kv ? L::kV : L::kK) + s * L::kStage;
#pragma unroll
          for (int j0 = 0; j0 < kTcKeys; j0 += kPass) {
            uint4 codes[kPer];
#pragma unroll
            for (int n = 0; n < kPer; ++n) {
              const int idx = threadIdx.x + 128 * n;
              const int j = j0 + idx / kUnits, u = idx % kUnits;  // key, unit
              if (idx < kPass * kUnits && (mask >> (j >> lp) & 1))
                codes[n] = *reinterpret_cast<const uint4*>(
                    tile + u * 16 +
                    (cm ? (j >> 3) * D * 16 + D * 8 + (j & 7) * D
                        : L::kCodes + (j >> lp) * page * 128 +
                              (j & (page - 1)) * D));
            }
            asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
            for (int n = 0; n < kPer; ++n) {
              const int idx = threadIdx.x + 128 * n;
              const int j = j0 + idx / kUnits, u = idx % kUnits;
              if (idx >= kPass * kUnits || !(mask >> (j >> lp) & 1)) continue;
              uint4 half[2];
              codes_to_bf16(codes[n], half[0], half[1]);
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int ch = 2 * u + hf;                  // bf16 chunk
                *reinterpret_cast<uint4*>(
                    tile + (cm ? (j >> 3) * D * 16 + ch * 128 + (j & 7) * 16
                               : (ch / 8) * kTcKeys * 128 + j * 128 +
                                     (((ch % 8) ^ (j % 8)) * 16))) =
                    half[hf];
              }
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
    }

    // S = Q.K^T on the tensor cores: D / 16 steps of k16
    float sc[kTcKeys / 2];
    const uint32_t k_tile = base + L::kK + s * L::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sw128_desc(
          base + L::kQ + (kk / 4) * kTcRows * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          cm ? core_desc(k_tile + kk * 256, 128, D * 16)
             : sw128_desc(k_tile + (kk / 4) * kTcKeys * 128 + (kk % 4) * 32,
                          16, 1024);
      Wgmma::ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragments: sc[4 i + e] is row r0 + 8 (e / 2),
    // local key k0 + 8 i + 2 tq + e % 2; a row's keys span the 4 threads of
    // a quad.  Keys 2 tq and 2 tq + 1 lie in one page for page >= 2 (the
    // second's position is the first's plus 1, its slot the same); at
    // 1-row pages (kOneRow) each has its own page and position
    const bool masked = gpos(k0 + kTcKeys - 1) > first;
    // kQuant: a stage holding int8 pages multiplies their keys' columns by
    // their scales, S's by k_scale before the softmax and P's by v_scale
    // after it, each in a pass of its own (see the int8 pages in the notes)
    auto scale = [&](const float* scales) {
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int slot = (8 * i + 2 * tq + (kOneRow ? u : 0)) >> lp;
          if (!(mask >> slot & 1)) continue;
          const float x = scales[slot];
          // __fmul_rn: never contracted, so the int8 kernel rounds as the
          // fp kernel does
          sc[4 * i + u] = __fmul_rn(sc[4 * i + u], x);
          sc[4 * i + 2 + u] = __fmul_rn(sc[4 * i + 2 + u], x);
        }
    };
    if constexpr (kQuant)
      if (mask) scale(meta[s].ks);
    float corr[2];
    {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i) {
        const int g0 = masked ? gpos(k0 + 8 * i + 2 * tq) : 0;
        const int g1 = kOneRow ? (masked ? gpos(k0 + 8 * i + 2 * tq + 1) : 0)
                               : g0 + 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(sc[4 * i + e], sl2);
          if (masked && ((e & 1) ? g1 : g0) > hz[e / 2])
            x = neg_inf();                     // p = 0
          sc[4 * i + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        corr[j] = exp2f(m[j] - mx[j]);  // m, mx >= the finite mask value
        m[j] = mx[j];
        l[j] = __fmul_rn(l[j], corr[j]);
      }
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * i + e] - m[e / 2]);  // masked: 0
          l[e / 2] += p;  // this thread's keys; the quad sums at the end
          sc[4 * i + e] = p;
        }
    }
    if constexpr (kQuant)
      if (mask) scale(meta[s].vs);
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
      Wgmma::rs(o, pa[kt],
                cm ? core_desc(v_tile + kt * 32 * D, D * 16, 128)
                   : sw128_desc(v_tile + kt * 16 * 128, kTcKeys * 128,
                                1024));
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
  if (merge) {
    // The cluster's merge.  Each thread leaves its fragment, o[D / 2]
    // unnormalised with its rows' m (log2 units of the scaled scores) and
    // l, in slots over the drained K and V rings, slot k of thread x at
    // [k][x]; after the cluster's barrier rank sp reads every rank's slots
    // of its own thread index (the same rows and columns) over distributed
    // shared memory and writes the column pairs i = sp, sp + n_clu, ... of
    // its rows: sum_r w_r o_r / max(sum_r w_r l_r, 1e-30), w_r =
    // 2^(m_r - max m), a rank whose split gave the row no key (l_r = 0:
    // past the lane's context, or beyond the row's horizon) weighing 0.
    // The second barrier keeps every rank's slots until all have read.
    float* slot = reinterpret_cast<float*>(smem + L::kK);
    const int x = threadIdx.x;
    const bool live = hz[0] >= 0 || hz[1] >= 0;   // a real row of its two
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the ring's last read
    if (live) {
#pragma unroll
      for (int k = 0; k < D / 2; ++k) slot[k * 128 + x] = o[k];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        slot[(D / 2 + j) * 128 + x] = m[j];
        slot[(D / 2 + 2 + j) * 128 + x] = l[j];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float* rs[kMaxCluster];
    float w[kMaxCluster][2], mm[2] = {neg_inf(), neg_inf()};
    float ll[2] = {0.f, 0.f};
    if (live) {
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk) {
        rs[rk] = rk < n_clu ? cluster.map_shared_rank(slot, rk) : slot;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool got =
              rk < n_clu && rs[rk][(D / 2 + 2 + j) * 128 + x] > 0.f;
          w[rk][j] = got ? rs[rk][(D / 2 + j) * 128 + x] : neg_inf();
          mm[j] = fmaxf(mm[j], w[rk][j]);
        }
      }
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // 0 for a rank without keys; mm is finite on a real row (some
          // rank saw its first key)
          w[rk][j] = w[rk][j] == neg_inf() ? 0.f : exp2f(w[rk][j] - mm[j]);
          if (rk < n_clu)
            ll[j] = fmaf(w[rk][j], rs[rk][(D / 2 + 2 + j) * 128 + x], ll[j]);
        }
    }
    // every thread writes its rows' columns of this rank (zeros on a
    // padding row, as the unsplit epilogue does)
    for (int i = sp; i < D / 8; i += n_clu) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
#pragma unroll
        for (int rk = 0; rk < kMaxCluster; ++rk) {
          if (rk >= n_clu) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = fmaf(w[rk][e / 2], rs[rk][(4 * i + e) * 128 + x], a[e]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 8 * j, qi = q0 + r / G;
        if (r >= rows || qi >= Sq) continue;
        const float denom = fmaxf(ll[j], 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Sq + qi) * H + h * G + r % G) * D + 8 * i +
            2 * tq) =
            hz[j] < 0 ? __floats2bfloat162_rn(0.f, 0.f)
                      : __floats2bfloat162_rn(a[2 * j] / denom,
                                              a[2 * j + 1] / denom);
      }
    }
    cluster.sync();
    return;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 8 * j, qi = q0 + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t at = ((size_t)b * Sq + qi) * H + h * G + r % G;
    const float denom = fmaxf(l[j], 1e-30f);
    if (part == nullptr) {
      __nv_bfloat16* dst = out + at * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)   // a padding row (hz < 0): zeros
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * tq) =
            hz[j] < 0 ? __floats2bfloat162_rn(0.f, 0.f)
                      : __floats2bfloat162_rn(o[4 * i + 2 * j] / denom,
                                              o[4 * i + 2 * j + 1] / denom);
      continue;
    }
    // the partial mode: o normalised over the split's keys in float32 (a
    // row that saw none has o = 0), and the natural-log lse (m is in log2
    // units of the scaled scores)
    float* dst = part + at * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i + 2 * tq) =
          hz[j] < 0 ? make_float2(0.f, 0.f)
                    : make_float2(o[4 * i + 2 * j] / denom,
                                  o[4 * i + 2 * j + 1] / denom);
    if (tq == 0)
      lse[at] = hz[j] < 0 || !(l[j] > 0.f)
                    ? neg_inf()
                    : (m[j] + log2f(l[j])) * 0.6931471805599453f;
  }
}

// A pool (P, page, Hkv, D) seen as (P * page, Hkv, D), innermost first:
// boxes of one page's rows of one kv head, 64 bf16 columns 128-byte swizzled
// (zeros past D), or with `codes` all D int8 columns unswizzled
bool pool_map(CUtensorMap* map, const void* base, bool codes, int P,
              int page, int Hkv, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = codes ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)P * page};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem,
                                 (cuuint64_t)Hkv * D * elem};
  const cuuint32_t box[3] = {codes ? (cuuint32_t)D : 64u, 1u,
                             (cuuint32_t)page};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The head-feature rung's pools of one side at dr = 8, shard r's (P,
// page, Hkv, 8) at base + r * stride bytes, seen as (8, Hkv, P * page,
// tp), innermost first (strides rising: 16, Hkv 16 bytes, stride): a box
// is every shard's 8 features of one kv head over 8 rows, landing as
// [shard][row][8 features] = tp core matrices of the rows, the columns in
// order, unswizzled
bool feat_map(CUtensorMap* map, const void* base, long long stride, int P,
              int page, int Hkv, int tp) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {8, (cuuint64_t)Hkv, (cuuint64_t)P * page,
                              (cuuint64_t)tp};
  const cuuint64_t strides[3] = {16, (cuuint64_t)Hkv * 16,
                                 (cuuint64_t)stride};
  const cuuint32_t box[4] = {8, 1, 8, (cuuint32_t)tp};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out: the bf16 output (B, Sq, H, D); in the partial mode (lse not null)
// the float32 partials (n_split, B, Sq, H, D) with lse (n_split, B, Sq, H).
// kOneRow: page == 1
template <int D, bool kQuant, bool kOneRow, bool kFeat>
cudaError_t launch_tc(const ShardArg<kFeat>& sh, const void* q,
                      const void* k_pages, const void* v_pages,
                      const QuantArgs& qa, const int* tables,
                      const int* q_offsets, const int* ctx_lens, void* out,
                      float* lse, int B, int Sq, int H, int Hkv, int P,
                      int page, int page_g, int r_off, int T_width, int split,
                      int n_split, int device, cudaStream_t stream) {
  // shard pages of 1 or 2 rows are gathered by cp.async: the pools' maps
  // are not read, so they are not encoded (a host cost on every launch of
  // the partial mode, once a shard and layer); the head-feature rung
  // encodes its feat_map boxes where it reads by TMA (and gathers its
  // int8 codes)
  CUtensorMap kmap{}, vmap{}, kqmap{}, vqmap{};
  if constexpr (kFeat) {
    if (sh.fp_tma &&
        (!feat_map(&kmap, sh.k[0], sh.stride[0], P, page, Hkv, sh.tp) ||
         !feat_map(&vmap, sh.v[0], sh.stride[1], P, page, Hkv, sh.tp)))
      return cudaErrorInvalidValue;
  } else {
    if (page > 2 && (!pool_map(&kmap, k_pages, false, P, page, Hkv, D) ||
                     !pool_map(&vmap, v_pages, false, P, page, Hkv, D)))
      return cudaErrorInvalidValue;
    if (kQuant && (!pool_map(&kqmap, qa.kq_pages, true, P, page, Hkv, D) ||
                   !pool_map(&vqmap, qa.vq_pages, true, P, page, Hkv, D)))
      return cudaErrorInvalidValue;
  }
  const int G = H / Hkv;
  const int bq = kTcRows / G;
  const int n_qblk = (Sq + bq - 1) / bq;
  const long long n_ctas = (long long)n_qblk * n_split * Hkv * B;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = PcSmem<D, kQuant, kQuant && !kFeat>::kAlloc;
  auto kern = paged_chunk_attention_tc<D, kQuant, kOneRow, kFeat>;
  // the shared-memory attribute once a card (bit `device` of `set`), not
  // on every launch: the partial mode launches once a shard and layer
  static unsigned long long set = 0;
  if (device >= 64 || !(set >> device & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // B.2's warpgroups trade registers (setmaxnreg) out of a CTA launched
    // with kCvtLaunchRegs a thread: any other count would leave the
    // consumers' request unmet, so the launch is refused instead
    if constexpr (kQuant && !kFeat) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kern);
      if (err != cudaSuccess) return err;
      if (attr.numRegs != kCvtLaunchRegs) return cudaErrorInvalidConfiguration;
    }
    if (device < 64) set |= 1ull << device;
  }
  // the unsplit entry's splits (lse null): one cluster of n_split CTAs a
  // (query tile, kv head, lane), merged inside the launch
  const int n_clu = lse == nullptr ? n_split : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_ctas);
  cfg.blockDim = dim3(kTcThreads<kFeat, kQuant>);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_clu;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_clu > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, sh, kmap, vmap, kqmap, vqmap,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), qa.k_scales, qa.v_scales,
      qa.page_quant, tables, q_offsets, ctx_lens,
      lse == nullptr ? static_cast<__nv_bfloat16*>(out) : nullptr,
      lse == nullptr ? nullptr : static_cast<float*>(out), lse, B, Sq, H, Hkv,
      page, page_g, r_off, T_width, bq, n_qblk, split, n_split, n_clu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// page: the rows a pool page holds.  With lse null, the kernel itself:
// out (B, Sq, H, D) in q's dtype.  With lse (the split-K partial mode) the
// pool is shard `shard`'s slice of pages of page * n_shards rows (1 to 32
// rows a shard page), and the shard's local keys are cut into n_split
// splits of `split` keys (a multiple of kTcKeys; n_split * split covers
// T_width * page): out receives the float32 partials (n_split, B, Sq, H,
// D), each normalised over its split's keys, and lse (n_split, B, Sq, H)
// their natural log-sum-exp (o = 0, lse = -inf where a row sees no key of
// the split).
// kFeat (the head-feature rung, lse null): the pools are the shards' in
// `sh`, pages of 1 to 32 rows.
template <bool kQuant, bool kFeat = false>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const QuantArgs& qa, const int* tables, const int* q_offsets,
             const int* ctx_lens, void* out, float* lse, int B, int Sq, int H,
             int Hkv, int D, int P, int page, int T_width, int n_shards,
             int shard, int split, int n_split, int dtype, int device,
             void* stream, const ShardArg<kFeat>& sh = ShardArg<kFeat>()) {
  if (lse == nullptr) {
    if (n_shards != 1 || n_split < 1 || n_split > kMaxCluster)
      return cudaErrorInvalidValue;
    if (kFeat ? (page < 1 || page > 32 || (page & (page - 1)) != 0)
              : (page != 8 && page != 16 && page != 32))
      return cudaErrorInvalidValue;
    // a split a cluster's rank: the bf16 body only, whole stages, every
    // split holding some of the table's keys
    if (n_split > 1 &&
        (dtype != 1 || split < kTcKeys || split % kTcKeys != 0 ||
         (long long)split * n_split < (long long)T_width * page ||
         (long long)split * (n_split - 1) >= (long long)T_width * page))
      return cudaErrorInvalidValue;
  } else {
    if (kFeat) return cudaErrorInvalidValue;
    if (n_shards < 1 || shard < 0 || shard >= n_shards)
      return cudaErrorInvalidValue;
    if (page != 1 && page != 2 && page != 4 && page != 8 && page != 16 &&
        page != 32)
      return cudaErrorInvalidValue;
    if (n_split < 1 || split < kTcKeys || split % kTcKeys != 0 ||
        (long long)split * n_split < (long long)T_width * page)
      return cudaErrorInvalidValue;
  }
  if ((long long)T_width * page * n_shards > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int page_g = page * n_shards, r_off = shard * page;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kRows) return cudaErrorInvalidValue;
  if (B > 65535 || Hkv > 65535 || P <= 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCA_FP32(DIM)                                                       \
  if (dtype == 0 && D == DIM)                                               \
    return launch<DIM, kQuant, kFeat>(sh, q, k_pages, v_pages, qa, tables, \
                                      q_offsets, ctx_lens, out, lse, B, Sq, \
                                      H, Hkv, page, page_g, r_off, T_width, \
                                      split, n_split, s);
#define PCA_BF16(DIM)                                                       \
  if (dtype == 1 && D == DIM)                                               \
    return (page == 1 ? launch_tc<DIM, kQuant, true, kFeat>                 \
                      : launch_tc<DIM, kQuant, false, kFeat>)(              \
        sh, q, k_pages, v_pages, qa, tables, q_offsets, ctx_lens, out, lse, \
        B, Sq, H, Hkv, P, page, page_g, r_off, T_width, split, n_split,     \
        device, s);
  PCA_FP32(64) PCA_FP32(80) PCA_FP32(96) PCA_FP32(128)
  PCA_BF16(64) PCA_BF16(80) PCA_BF16(96) PCA_BF16(128)
#undef PCA_FP32
#undef PCA_BF16
  return cudaErrorInvalidValue;
}

// the bf16 body at pages of 2 rows or more, or (kOneRow) of 1 row (with
// kFeat, the head-feature rung's); the float32 body has one kind
template <bool kQuant, bool kOneRow, bool kFeat>
cudaError_t body_resources(int D, int dtype, int* out) {
#define PCA_RES(DIM)                                                        \
  if (dtype == 0 && D == DIM)                                               \
    return resources(paged_chunk_attention_kernel<float, DIM, kQuant, kFeat>, \
                     kThreads, 0, out);                                     \
  if (dtype == 1 && D == DIM)                                               \
    return resources(paged_chunk_attention_tc<DIM, kQuant, kOneRow, kFeat>,  \
                     kTcThreads<kFeat, kQuant>,                             \
                     PcSmem<DIM, kQuant, kQuant && !kFeat>::kAlloc, out);
  PCA_RES(64) PCA_RES(80) PCA_RES(96) PCA_RES(128)
#undef PCA_RES
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body); P pool pages.  split, n_split: the wrapper's plan
// (paged_attention.chunk_split_plan): n_split = 1, or (bf16 only) 2 to
// kMaxCluster splits of `split` keys, a multiple of kTcKeys, over one
// cluster a (query tile, kv head, lane), merged in the launch.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* q_offsets, const int* ctx_lens, void* out,
    int B, int Sq, int H, int Hkv, int D, int P, int page, int T_width,
    int split, int n_split, int dtype, int device, void* stream) {
  const QuantArgs none = {nullptr, nullptr, nullptr, nullptr, nullptr};
  return dispatch<false>(q, k_pages, v_pages, none, tables, q_offsets,
                         ctx_lens, out, nullptr, B, Sq, H, Hkv, D, P, page,
                         T_width, 1, 0, split, n_split, dtype, device,
                         stream);
}

// The int8 kernel: kq/vq_pages (P, page, Hkv, D) int8, k/v_scales (P,)
// float32, page_quant (P,) int32 (nonzero = read the int8 pools); split
// and n_split as kernel 1's (the same plan, so that with every flag clear
// the two are bit-identical).
extern "C" int paged_chunk_attention_quant_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kq_pages, const void* vq_pages, const float* k_scales,
    const float* v_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, void* out, int B, int Sq,
    int H, int Hkv, int D, int P, int page, int T_width, int split,
    int n_split, int dtype, int device, void* stream) {
  const QuantArgs qa = {static_cast<const int8_t*>(kq_pages),
                        static_cast<const int8_t*>(vq_pages), k_scales,
                        v_scales, page_quant};
  return dispatch<true>(q, k_pages, v_pages, qa, tables, q_offsets, ctx_lens,
                        out, nullptr, B, Sq, H, Hkv, D, P, page, T_width, 1,
                        0, split, n_split, dtype, device, stream);
}

// The split-K partial mode of either kernel: the pools (P, page, Hkv, D)
// are shard `shard`'s rows of pages of page * n_shards rows (and the quant
// pointers are null for kernel 1); part (n_split, B, Sq, H, D) and lse
// (n_split, B, Sq, H) float32, as `dispatch` says.
extern "C" int paged_chunk_attention_partial_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* kq_pages, const void* vq_pages, const float* k_scales,
    const float* v_scales, const int* page_quant, const int* tables,
    const int* q_offsets, const int* ctx_lens, float* part, float* lse,
    int B, int Sq, int H, int Hkv, int D, int P, int page, int T_width,
    int n_shards, int shard, int split, int n_split, int dtype, int device,
    void* stream) {
  if (part == nullptr || lse == nullptr) return cudaErrorInvalidValue;
  const QuantArgs qa = {static_cast<const int8_t*>(kq_pages),
                        static_cast<const int8_t*>(vq_pages), k_scales,
                        v_scales, page_quant};
  if (page_quant != nullptr)
    return dispatch<true>(q, k_pages, v_pages, qa, tables, q_offsets,
                          ctx_lens, part, lse, B, Sq, H, Hkv, D, P, page,
                          T_width, n_shards, shard, split, n_split, dtype,
                          device, stream);
  return dispatch<false>(q, k_pages, v_pages, qa, tables, q_offsets,
                         ctx_lens, part, lse, B, Sq, H, Hkv, D, P, page,
                         T_width, n_shards, shard, split, n_split, dtype,
                         device, stream);
}

// The merge of one split-K call (csrc/split_kv.cuh, split_kv_merge): part
// (N, B, Sq, H, D) and lse (N, B, Sq, H) float32, the N = shards x splits
// partials side by side; out (B, Sq, H, D) in dtype (0 float32, 1
// bfloat16).  Returns a cudaError_t (0 = launched).
extern "C" int paged_chunk_attention_merge_launch(
    const float* part, const float* lse, void* out, int N, int B, int Sq,
    int H, int D, int dtype, int device, void* stream) {
  if (N < 1 || D % 4 != 0 || D > 128 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const long long R = (long long)B * Sq * H;
  if (R == 0) return cudaSuccess;
  const long long n_ctas = (R + kMergeRows - 1) / kMergeRows;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    split_kv_merge<float><<<(unsigned)n_ctas, kMergeThreads, 0, s>>>(
        part, lse, static_cast<float*>(out), N, R, D);
  else
    split_kv_merge<__nv_bfloat16><<<(unsigned)n_ctas, kMergeThreads, 0, s>>>(
        part, lse, static_cast<__nv_bfloat16*>(out), N, R, D);
  return cudaGetLastError();
}

// out[5]: the `resources` of the body that the launch runs for (dtype, D,
// quant; one_row: pages of 1 row, the split-K partial mode's):
// registers, local bytes, shared memory, CTAs per SM, threads.  Returns a
// cudaError_t.
extern "C" int paged_chunk_attention_resources(int D, int dtype, int quant,
                                               int one_row, int device,
                                               int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (one_row)
    return quant ? body_resources<true, true, false>(D, dtype, out)
                 : body_resources<false, true, false>(D, dtype, out);
  return quant ? body_resources<true, false, false>(D, dtype, out)
               : body_resources<false, false, false>(D, dtype, out);
}

// The head-feature rung's route of either kernel: q and out (B, Sq, H, D)
// full heads, D = tp * dr; pools a host array of 4 * tp pointers, shard
// r's K, V, int8 K and int8 V pools (P, page, Hkv, dr) at r, tp + r, 2 tp +
// r and 3 tp + r (the int8 ones null, with the scales and flags, for kernel
// 1's route); strides a host array of 2, the bytes from one shard's K (V)
// pool to the next's where they are all one (a multiple of 16), else 0.
// The scales and flags (P,) are the pages' own, one set for every shard.
// dr a power of 2 from 2 to 64, tp at most kMaxShards, page 1 to 32 rows.
// tma: read K and V by TMA (bf16, dr = 8, pages of a multiple of 8 rows,
// both strides set), else gather them by cp.async.  split, n_split: kernel
// 1's plan for the same call, so that the output stays bit-equal to the
// kernel's on the concatenated pools.  Returns a cudaError_t (0 =
// launched).
extern "C" int paged_chunk_attention_features_launch(
    const void* q, const void* const* pools, const long long* strides,
    const float* k_scales, const float* v_scales, const int* page_quant,
    const int* tables, const int* q_offsets, const int* ctx_lens, void* out,
    int B, int Sq, int H, int Hkv, int D, int P, int page, int T_width,
    int tp, int tma, int split, int n_split, int dtype, int device,
    void* stream) {
  if (pools == nullptr || strides == nullptr || tp < 1 || tp > kMaxShards ||
      D % tp != 0)
    return cudaErrorInvalidValue;
  const int dr = D / tp;
  if (dr < 2 || (dr & (dr - 1)) != 0) return cudaErrorInvalidValue;
  ShardPools sh{};
  sh.ldr = __builtin_ctz(dr);
  sh.tp = tp;
  for (int i = 0; i < 2; ++i) {
    if (strides[i] < 0 || strides[i] % 16 != 0) return cudaErrorInvalidValue;
    sh.stride[i] = strides[i];
  }
  const bool quant = page_quant != nullptr;
  // TMA boxes of 8 rows of 16 bytes a shard (a core matrix each)
  if (tma && (dtype != 1 || dr != 8 || page % 8 != 0 || strides[0] == 0 ||
              strides[1] == 0))
    return cudaErrorInvalidValue;
  sh.fp_tma = tma != 0;
  for (int r = 0; r < tp; ++r) {
    sh.k[r] = pools[r];
    sh.v[r] = pools[tp + r];
    sh.kq[r] = pools[2 * tp + r];
    sh.vq[r] = pools[3 * tp + r];
    if (sh.k[r] == nullptr || sh.v[r] == nullptr ||
        (quant && (sh.kq[r] == nullptr || sh.vq[r] == nullptr)))
      return cudaErrorInvalidValue;
  }
  const QuantArgs qa = {nullptr, nullptr, k_scales, v_scales, page_quant};
  if (quant)
    return dispatch<true, true>(q, nullptr, nullptr, qa, tables, q_offsets,
                                ctx_lens, out, nullptr, B, Sq, H, Hkv, D, P,
                                page, T_width, 1, 0, split, n_split, dtype,
                                device, stream, sh);
  return dispatch<false, true>(q, nullptr, nullptr, qa, tables, q_offsets,
                               ctx_lens, out, nullptr, B, Sq, H, Hkv, D, P,
                               page, T_width, 1, 0, split, n_split, dtype,
                               device, stream, sh);
}

// out[5]: the `resources` of the body that the head-feature route runs for
// (dtype, D, quant) at pages of 2 rows or more.  Returns a cudaError_t.
extern "C" int paged_chunk_attention_features_resources(int D, int dtype,
                                                        int quant, int device,
                                                        int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return quant ? body_resources<true, false, true>(D, dtype, out)
               : body_resources<false, false, true>(D, dtype, out);
}
