// The chunked SSD (Mamba-2) scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (`_kernel`, pallas_call in `ssd_scan`), and serves the JAX model's jnp
// scan `Zamba2LM._ssd_scan` (src/repro/models/mamba2.py), which every
// Mamba2 layer of the recurrent and hybrid families runs on every serving
// step.  Contract: x (B, S, H, P) already scaled by dt; dA (B, S, H) float32
// log decays; Bm, Cm (B, S, G, N) with H % G == 0 (head h reads group
// h / (H / G)); an optional float32 initial state (B, H, N, P); the float32
// final state (B, H, N, P) is written out.  y (B, S, H, P) has x's dtype.
// With G = H and no initial state, y is the TPU kernel's output (it returns
// no state).  All arithmetic is float32.
//
// What it computes, per chunk of kQ steps, with cs the running sum of dA
// inside the chunk:
//   Y      = ((C B^T) o exp(cs_i - cs_j) o [j <= i]) x  +  (C h) o exp(cs)
//   h_next = exp(cs_last) h + B^T (exp(cs_last - cs) o x)
// Any chunk length gives the same function up to rounding, so the kernel
// picks its own (kQ = 32) whatever chunk the model uses.  Steps past S in
// the last chunk read as dA = 0 and zero inputs: exact identities on h.
// The segment cs_i - cs_j is exponentiated only where j <= i (exp of a
// positive segment overflows).
//
// Design.  The TPU kernel keeps h in VMEM across a sequential grid axis of
// chunks; blocks on the card run in no order, so here one CTA of 128
// threads owns one (lane, head, slice of kPs = 16 columns of P) and walks
// the chunks in a loop, with h in registers (each thread owns kMaxN / 8
// state rows of one column) mirrored to shared memory for the C h product.
// Columns of P are independent, so slicing P is exact and gives B x H x
// P / 16 CTAs (2560 at decode B = 8 for zamba2-2.7b).  Per chunk the CTA
// stages x, B^T, C^T and the decays in shared memory, forms the kQ x kQ
// decayed score matrix L (one warp per 8 rows, one lane per column), then
// each thread computes 4 rows of y for its column and its state rows'
// update.  Shared memory is 48.6 KB at N = 128 (kMaxN picks 16, 32, 64 or
// 128 rows), under the 48 KB-per-block static limit's 49152 bytes.
//
// What bounds it.  At decode (S = 1) the work is the state: (B, H, N, P)
// float32 read and written once, 2 x 1.31 MB a lane and layer at zamba2
// widths (N = 64), against a few hundred FLOPs per column, so bytes bound
// it.  At long chunks the operations do: the function needs about 4 N P
// operations a step and head (the state update and C h; any chunk length
// computes it), and this kernel does about S x H x (kQ N + kQ P + 2 N P)
// FMAs for the causal score tiles, the intra-chunk product, C h and the
// state update, on the CUDA cores in float32.
//
// What this simple version leaves on the table: no tensor cores (the score
// and state products are small GEMMs that mma/wgmma could take), no
// cp.async or TMA pipeline (every chunk's loads are exposed), the C B^T
// tile is recomputed by each of the P / 16 slices of a head and by each
// head of a group, and the decays' running sum is one thread's loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 32;                  // steps per inner chunk
constexpr int kPs = 16;                 // columns of P per CTA
constexpr int kGroups = kThreads / kPs; // threads per column (8)
constexpr int kRowsY = kQ / kGroups;    // rows of y per thread (4)
constexpr int kLd = kQ + 1;             // padded row: conflict-free columns

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

// x, y (B, S, H, P); dA (B, S, H); Bm, Cm (B, S, G, N); init (B, H, N, P)
// or null; fin (B, H, N, P).  All contiguous.  N <= kMaxN.
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ fin, int S, int H, int P, int G, int N) {
  constexpr int kNr = kMaxN / kGroups;  // state rows per thread
  __shared__ float c_t[kMaxN][kLd];     // C^T of the chunk: c_t[n][i]
  __shared__ float b_t[kMaxN][kLd];     // B^T of the chunk: b_t[n][j]
  __shared__ float l_s[kQ][kLd];        // decayed scores L[i][j]
  __shared__ float x_s[kQ][kPs];
  __shared__ float h_s[kMaxN][kPs];     // the state before this chunk
  __shared__ float cs_s[kQ], w_s[kQ], e_s[kQ];

  const int n_slices = (P + kPs - 1) / kPs;
  const int h = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x % n_slices) * kPs;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int pc = tid % kPs;             // this thread's column of the slice
  const int grp = tid / kPs;            // its state rows: grp + kGroups * r
  const bool p_ok = p0 + pc < P;
  const size_t hstate = ((size_t)b * H + h) * N * P;

  float hr[kNr];
#pragma unroll
  for (int r = 0; r < kNr; ++r) {
    const int n = grp + kGroups * r;
    float v = 0.f;
    if (init != nullptr && n < N && p_ok) v = init[hstate + (size_t)n * P + p0 + pc];
    hr[r] = v;
    h_s[n][pc] = v;
  }

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < kQ * kPs; i += kThreads) {
      const int t = i / kPs, pp = i % kPs;
      float v = 0.f;
      if (t < nq && p0 + pp < P)
        v = to_f32(x[(((size_t)b * S + c0 + t) * H + h) * P + p0 + pp]);
      x_s[t][pp] = v;
    }
    for (int i = tid; i < kQ * kMaxN; i += kThreads) {
      const int t = i / kMaxN, n = i % kMaxN;
      float bv = 0.f, cv = 0.f;
      if (t < nq && n < N) {
        const size_t o = (((size_t)b * S + c0 + t) * G + g) * N + n;
        bv = to_f32(Bm[o]);
        cv = to_f32(Cm[o]);
      }
      b_t[n][t] = bv;
      c_t[n][t] = cv;
    }
    if (tid == 0) {  // running sum of the chunk's log decays, in order
      float acc = 0.f;
      for (int t = 0; t < kQ; ++t) {
        if (t < nq) acc += dA[((size_t)b * S + c0 + t) * H + h];
        cs_s[t] = acc;
      }
    }
    __syncthreads();
    const float cs_last = cs_s[nq - 1];
    if (tid < kQ) {
      w_s[tid] = tid < nq ? expf(cs_last - cs_s[tid]) : 0.f;
      e_s[tid] = expf(cs_s[tid]);
    }
    {  // L[i][j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i < nq, else 0
      const int j = tid % kQ;
      const int i0 = (tid / kQ) * (kQ / (kThreads / kQ));
      constexpr int kRowsL = kQ / (kThreads / kQ);  // 8
      float acc[kRowsL];
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) acc[r] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float bv = b_t[n][j];
#pragma unroll
        for (int r = 0; r < kRowsL; ++r) acc[r] = fmaf(c_t[n][i0 + r], bv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsL; ++r) {
        const int i = i0 + r;
        l_s[i][j] = (j <= i && i < nq) ? acc[r] * expf(cs_s[i] - cs_s[j]) : 0.f;
      }
    }
    __syncthreads();
    {  // y rows i0 .. i0 + 3 of column pc
      const int i0 = grp * kRowsY;
      float yd[kRowsY], yo[kRowsY];
#pragma unroll
      for (int r = 0; r < kRowsY; ++r) yd[r] = yo[r] = 0.f;
      const int jmax = min(i0 + kRowsY, nq);
      for (int j = 0; j < jmax; ++j) {
        const float xv = x_s[j][pc];
#pragma unroll
        for (int r = 0; r < kRowsY; ++r) yd[r] = fmaf(l_s[i0 + r][j], xv, yd[r]);
      }
      for (int n = 0; n < N; ++n) {
        const float hv = h_s[n][pc];
#pragma unroll
        for (int r = 0; r < kRowsY; ++r) yo[r] = fmaf(c_t[n][i0 + r], hv, yo[r]);
      }
      if (p_ok) {
#pragma unroll
        for (int r = 0; r < kRowsY; ++r) {
          const int i = i0 + r;
          if (i < nq)
            y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + pc] =
                from_f32<T>(yd[r] + yo[r] * e_s[i]);
        }
      }
    }
    {  // this thread's state rows: h <- exp(cs_last) h + sum_j B_j w_j x_j
      float sa[kNr];
#pragma unroll
      for (int r = 0; r < kNr; ++r) sa[r] = 0.f;
      for (int j = 0; j < nq; ++j) {
        const float xw = x_s[j][pc] * w_s[j];
#pragma unroll
        for (int r = 0; r < kNr; ++r)
          sa[r] = fmaf(b_t[grp + kGroups * r][j], xw, sa[r]);
      }
      const float decay = expf(cs_last);
#pragma unroll
      for (int r = 0; r < kNr; ++r) hr[r] = fmaf(hr[r], decay, sa[r]);
    }
    __syncthreads();  // every thread is done reading h_s
#pragma unroll
    for (int r = 0; r < kNr; ++r) h_s[grp + kGroups * r][pc] = hr[r];
  }

  if (p_ok) {
#pragma unroll
    for (int r = 0; r < kNr; ++r) {
      const int n = grp + kGroups * r;
      if (n < N) fin[hstate + (size_t)n * P + p0 + pc] = hr[r];
    }
  }
}

template <typename T, int kMaxN>
cudaError_t launch(const void* x, const float* dA, const void* Bm,
                   const void* Cm, const float* init, void* y, float* fin,
                   int B, int S, int H, int P, int G, int N,
                   cudaStream_t stream) {
  const int n_slices = (P + kPs - 1) / kPs;
  const dim3 grid(H * n_slices, B);
  ssd_scan_kernel<T, kMaxN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dA, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fin, S, H, P, G,
      N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* x, const float* dA, const void* Bm,
                     const void* Cm, const float* init, void* y, float* fin,
                     int B, int S, int H, int P, int G, int N,
                     cudaStream_t s) {
  if (N <= 16)
    return launch<T, 16>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N, s);
  if (N <= 32)
    return launch<T, 32>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N, s);
  if (N <= 64)
    return launch<T, 64>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N, s);
  return launch<T, 128>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N, s);
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  init may be null.
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const float* dA, const void* Bm,
                               const void* Cm, const float* init, void* y,
                               float* fin, int B, int S, int H, int P, int G,
                               int N, int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || S < 0)
    return cudaErrorInvalidValue;
  if (H % G != 0 || N > 128 || B > 65535) return cudaErrorInvalidValue;
  if ((long long)H * ((P + kPs - 1) / kPs) > 2147483647LL)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (fin == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G, N, s);
  return launch_n<__nv_bfloat16>(x, dA, Bm, Cm, init, y, fin, B, S, H, P, G,
                                 N, s);
}
