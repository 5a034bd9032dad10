// token_logprob: per-row target logprob and entropy over the whole vocabulary,
// forward and backward, without ever storing the [R, V] logits.
//
// Replaces the TPU kernel src/repro/kernels/token_logprob.py:87
// token_logprob_flat (body _logprob_kernel, reached through
// kernels/ops.py::token_logprob from rl/grpo.py::token_logprobs_chunked). The
// TPU kernel has no backward; this file adds one for dh (W is the frozen base).
//
//   z      = softcap(h @ W)                  h [R, d], W [d, V], fp32 accumulate
//   lse    = m + log(max(l, 1e-30))          m = max z, l = sum e^(z-m)
//   lp     = z[target] - lse                 ent = lse - s / max(l, 1e-30),
//                                            s = sum z e^(z-m)
//   dz_j   = g_lp (1[j=t] - p_j) - g_ent p_j (z_j - lse + ent),  p_j = e^(z_j - lse)
//            (times 1 - tanh^2(raw/cap) under a softcap)
//   dh     = dz @ W^T
//
// What bounds it on an H100: the logits product, 2*R*d*V operations forward
// (4*R*d*V backward: the logits are recomputed, then dz @ W^T); at R = 624,
// d = 1024, V = 151936 that is 1.9e11 operations, 0.2 ms at 989 TFLOP/s bf16,
// against 0.1 ms to read W's 311 MB once. Below about R = 300 rows the bytes
// of W bound it instead.
//
// Design (not the Pallas grid, which walks the vocab in sequence per row
// block and carries m, l, s in VMEM scratch):
//  * Blocks tile rows AND the vocabulary: grid (row blocks, vocab slices), so
//    a training micro-batch of a few hundred rows still fills the 132 SMs.
//    Each block walks its slice in 64-column tiles; each tile's logits are
//    made in the block itself, h and W streamed through shared memory in
//    32-wide d-chunks. bf16 inputs use tensor cores (wmma 16x16x16, fp32
//    accumulate); fp32 inputs use an fp32 FMA loop (no TF32: fp32 stays
//    fp32). W comes with its two strides, so the tied [V, d] embedding is read
//    as [d, V] in place (k contiguous: 16-byte vector loads) and an untied
//    [d, V] head as it lies (v contiguous: coalesced scalar loads).
//  * The ragged last vocab tile is masked (columns >= V take no part), so V
//    need not divide by anything.
//  * Forward: each block keeps (m, l, s, target logit) per row for its slice
//    and writes them as one partial; a second launch merges the slices of
//    each row in slice order, so results do not depend on scheduling.
//  * Backward: row blocks of 32, the dh accumulator [32, <=1024] fp32 lives in
//    shared memory. Per vocab tile the block recomputes the logits, forms dz
//    in shared memory (bf16 for bf16 inputs, as a bf16 autograd would), and
//    adds dz @ W_tile^T into the accumulator chunk by chunk. Each vocab slice
//    writes its own partial dh; a reduce launch sums the slices in order and
//    casts to h's dtype. No float atomics anywhere: every run gives the same
//    bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // 4 warps per block
constexpr int BN = 64;            // vocab columns per tile
constexpr int BK = 32;            // d-chunk streamed through shared memory
constexpr int BM_FWD = 64;        // rows per forward block
constexpr int BM_BWD = 32;        // rows per backward block
constexpr int ZLD = BN + 4;       // row stride of the fp32 logits tile
constexpr float kNegInf = -1e30f;

template <typename T> struct Tr;
template <> struct Tr<float> {    // FMA path: odd strides keep banks apart
  static constexpr int LD = BK + 1, DZLD = BN + 1, VEC = 4;
};
template <> struct Tr<bf16> {     // wmma path: strides multiples of 8 elements
  static constexpr int LD = BK + 8, DZLD = BN + 8, VEC = 8;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float capz(float z, float cap) {
  return cap != 0.f ? tanhf(z / cap) * cap : z;
}

// dst[r * LD + k] = src[(r0 + r) * s_r + (k0 + k) * s_k] for r < ROWS, k < BK;
// zero outside r0 + r < r_lim, k0 + k < k_lim. `vec`: s_k == 1, rows and base
// 16-byte aligned and k_lim a multiple of VEC, so a vector is all in or out.
template <typename T, int ROWS>
__device__ __forceinline__ void load_chunk(T* dst, const T* __restrict__ src, long long s_r,
                                           long long s_k, int r0, int r_lim, int k0, int k_lim,
                                           bool vec) {
  constexpr int LD = Tr<T>::LD;
  if (vec) {
    constexpr int V = Tr<T>::VEC;
    constexpr int PER_ROW = BK / V;
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, k = (i % PER_ROW) * V;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < r_lim && k0 + k < k_lim)
        u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * s_r + (k0 + k));
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * LD + k + j] = v[j];
    }
  } else if (s_k == 1) {          // k contiguous: neighbouring threads along k
    for (int i = threadIdx.x; i < ROWS * BK; i += kThreads) {
      const int r = i / BK, k = i % BK;
      T x = from_f<T>(0.f);
      if (r0 + r < r_lim && k0 + k < k_lim) x = src[(size_t)(r0 + r) * s_r + (k0 + k)];
      dst[r * LD + k] = x;
    }
  } else {                        // rows contiguous: neighbouring threads along r
    for (int i = threadIdx.x; i < ROWS * BK; i += kThreads) {
      const int r = i % ROWS, k = i / ROWS;
      T x = from_f<T>(0.f);
      if (r0 + r < r_lim && k0 + k < k_lim)
        x = src[(size_t)(r0 + r) * s_r + (size_t)(k0 + k) * s_k];
      dst[r * LD + k] = x;
    }
  }
}

// Logits tile accumulator: [BM, BN] += sH[BM, BK] . sW[BN, BK]^T over chunks.
template <typename T, int BM> struct ZAcc;

// bf16: warp w owns rows (w/2)*BM/2 .. +BM/2 and columns (w%2)*32 .. +32.
template <int BM> struct ZAcc<bf16, BM> {
  static constexpr int FR = BM / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[FR][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ __forceinline__ void mma(const bf16* sH, const bf16* sW) {
    constexpr int LD = Tr<bf16>::LD;
    const int w = threadIdx.x / 32, r0 = (w / 2) * (BM / 2), n0 = (w % 2) * 32;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FR];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < FR; ++i) wmma::load_matrix_sync(a[i], sH + (r0 + 16 * i) * LD + ks, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sW + (n0 + 16 * j) * LD + ks, LD);
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* sZ) {
    const int w = threadIdx.x / 32, r0 = (w / 2) * (BM / 2), n0 = (w % 2) * 32;
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sZ + (r0 + 16 * i) * ZLD + n0 + 16 * j, c[i][j], ZLD,
                                wmma::mem_row_major);
  }
};

// fp32: thread (tr, tc) owns rows tr + 8i and columns tc + 16j.
template <int BM> struct ZAcc<float, BM> {
  static constexpr int RI = BM / 8;
  float c[RI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void mma(const float* sH, const float* sW) {
    constexpr int LD = Tr<float>::LD;
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[(tc + 16 * j) * LD + k];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = sH[(tr + 8 * i) * LD + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a, b[j], c[i][j]);
      }
    }
  }
  __device__ __forceinline__ void store(float* sZ) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sZ[(tr + 8 * i) * ZLD + tc + 16 * j] = c[i][j];
  }
};

// Backward: acc[BM_BWD, BK] += sDz[BM_BWD, BN] . sW[BN, BK] (sW holds W^T's
// chunk: element (n, k) = W[k0 + k, n0 + n]); acc is a chunk of the shared
// dh accumulator with row stride dld.
__device__ __forceinline__ void dh_chunk(const bf16* sDz, const bf16* sW, float* acc, int dld) {
  constexpr int LD = Tr<bf16>::LD, DZLD = Tr<bf16>::DZLD;
  const int w = threadIdx.x / 32, r0 = (w / 2) * 16, c0 = (w % 2) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::load_matrix_sync(c, acc + r0 * dld + c0, dld, wmma::mem_row_major);
#pragma unroll
  for (int n = 0; n < BN; n += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, sDz + r0 * DZLD + n, DZLD);
    wmma::load_matrix_sync(b, sW + n * LD + c0, LD);
    wmma::mma_sync(c, a, b, c);
  }
  wmma::store_matrix_sync(acc + r0 * dld + c0, c, dld, wmma::mem_row_major);
}

__device__ __forceinline__ void dh_chunk(const float* sDz, const float* sW, float* acc, int dld) {
  constexpr int LD = Tr<float>::LD, DZLD = Tr<float>::DZLD;
  const int k = threadIdx.x % 32, rg = threadIdx.x / 32;
  float c[BM_BWD / 4];
#pragma unroll
  for (int i = 0; i < BM_BWD / 4; ++i) c[i] = 0.f;
#pragma unroll 4
  for (int n = 0; n < BN; ++n) {
    const float b = sW[n * LD + k];
#pragma unroll
    for (int i = 0; i < BM_BWD / 4; ++i) c[i] = fmaf(sDz[(rg + 4 * i) * DZLD + n], b, c[i]);
  }
#pragma unroll
  for (int i = 0; i < BM_BWD / 4; ++i) acc[(rg + 4 * i) * dld + k] += c[i];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
tlp_fwd(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ tgt,
        float4* __restrict__ part, int R, int d, int V, long long ws_k, long long ws_v,
        int slice_tiles, float cap, int vec_h, int vec_w) {
  constexpr int BM = BM_FWD;
  constexpr int LD = Tr<T>::LD;
  constexpr int TPR = kThreads / BM;              // threads per row for the statistics
  __shared__ __align__(128) T sH[BM * LD];
  __shared__ __align__(128) T sW[BN * LD];
  __shared__ __align__(128) float sZ[BM * ZLD];

  const int row0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int t0 = blockIdx.y * slice_tiles;
  const int t1 = min(n_tiles, t0 + slice_tiles);
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int grow = row0 + r;
  const int target = grow < R ? tgt[grow] : -1;
  float m = kNegInf, l = 0.f, s = 0.f, tv = kNegInf;
  ZAcc<T, BM> acc;

  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    acc.zero();
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_chunk<T, BM>(sH, h, d, 1, row0, R, k0, d, vec_h);
      load_chunk<T, BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
      __syncthreads();
      acc.mma(sH, sW);
      __syncthreads();
    }
    acc.store(sZ);
    __syncthreads();
    const int ncols = min(BN, V - n0);
    const float* zr = sZ + r * ZLD;
    float tmax = kNegInf;
    for (int j = sub; j < ncols; j += TPR) tmax = fmaxf(tmax, capz(zr[j], cap));
    const float mn = fmaxf(m, tmax);
    float ls = 0.f, ss = 0.f;
    for (int j = sub; j < ncols; j += TPR) {
      const float z = capz(zr[j], cap);
      const float p = expf(z - mn);
      ls += p;
      ss += p * z;
      if (n0 + j == target) tv = z;
    }
    const float alpha = expf(m - mn);
    l = l * alpha + ls;
    s = s * alpha + ss;
    m = mn;
    __syncthreads();              // sZ is rewritten by the next tile
  }
  // the TPR threads of a row merge their partials (xor pairs: both sides
  // compute the same sums, in a fixed order)
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float t2 = __shfl_xor_sync(0xffffffffu, tv, off);
    const float mn = fmaxf(m, m2);
    const float a1 = expf(m - mn), a2 = expf(m2 - mn);
    l = l * a1 + l2 * a2;
    s = s * a1 + s2 * a2;
    m = mn;
    tv = fmaxf(tv, t2);
  }
  if (sub == 0 && grow < R) part[(size_t)blockIdx.y * R + grow] = make_float4(m, l, s, tv);
}

// One thread per row: merges the vocab slices' partials in slice order.
__global__ void tlp_merge(const float4* __restrict__ part, int R, int vsplit,
                          float* __restrict__ lp, float* __restrict__ ent,
                          float* __restrict__ lse_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float M = kNegInf;
  for (int v = 0; v < vsplit; ++v) M = fmaxf(M, part[(size_t)v * R + row].x);
  float L = 0.f, S = 0.f, Tv = kNegInf;
  for (int v = 0; v < vsplit; ++v) {
    const float4 p = part[(size_t)v * R + row];
    const float e = expf(p.x - M);
    L += p.y * e;
    S += p.z * e;
    Tv = fmaxf(Tv, p.w);
  }
  const float lse = M + logf(fmaxf(L, 1e-30f));
  lp[row] = Tv - lse;
  ent[row] = lse - S / fmaxf(L, 1e-30f);
  lse_out[row] = lse;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t round128(size_t b) { return (b + 127) & ~(size_t)127; }

struct BwdSmem {                  // byte offsets into the dynamic shared memory
  size_t w, z, dz, row, acc, total;
};

template <typename T>
__host__ __device__ inline BwdSmem bwd_smem(int dld) {
  BwdSmem o;
  o.w = round128(sizeof(T) * BM_BWD * Tr<T>::LD);
  o.z = o.w + round128(sizeof(T) * BN * Tr<T>::LD);
  o.dz = o.z + round128(sizeof(float) * BM_BWD * ZLD);
  o.row = o.dz + round128(sizeof(T) * BM_BWD * Tr<T>::DZLD);
  o.acc = o.row + round128(sizeof(float) * 5 * BM_BWD);
  o.total = o.acc + round128(sizeof(float) * (size_t)BM_BWD * dld);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tlp_bwd(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ tgt,
        const float* __restrict__ lse, const float* __restrict__ ent,
        const float* __restrict__ g_lp, const float* __restrict__ g_ent,
        float* __restrict__ dpart, int R, int d, int V, long long ws_k, long long ws_v,
        int slice_tiles, int dch, float cap, int vec_h, int vec_w) {
  constexpr int BM = BM_BWD;
  constexpr int LD = Tr<T>::LD, DZLD = Tr<T>::DZLD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dld = dch + 4;
  const BwdSmem o = bwd_smem<T>(dld);
  T* sH = reinterpret_cast<T*>(smem);
  T* sW = reinterpret_cast<T*>(smem + o.w);
  float* sZ = reinterpret_cast<float*>(smem + o.z);
  T* sDz = reinterpret_cast<T*>(smem + o.dz);
  float* s_lse = reinterpret_cast<float*>(smem + o.row);
  float* s_ent = s_lse + BM;
  float* s_glp = s_ent + BM;
  float* s_gent = s_glp + BM;
  int* s_tgt = reinterpret_cast<int*>(s_gent + BM);
  float* dacc = reinterpret_cast<float*>(smem + o.acc);

  const int row0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int t0 = blockIdx.y * slice_tiles;
  const int t1 = min(n_tiles, t0 + slice_tiles);
  const int kd0 = blockIdx.z * dch;
  const int kd1 = min(d, kd0 + dch);

  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const int g = row0 + i;
    const bool ok = g < R;
    s_lse[i] = ok ? lse[g] : 0.f;
    s_ent[i] = ok ? ent[g] : 0.f;
    s_glp[i] = ok ? g_lp[g] : 0.f;
    s_gent[i] = ok ? g_ent[g] : 0.f;
    s_tgt[i] = ok ? tgt[g] : -1;
  }
  for (int i = threadIdx.x; i < BM * dld; i += kThreads) dacc[i] = 0.f;
  __syncthreads();

  ZAcc<T, BM> acc;
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    acc.zero();
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_chunk<T, BM>(sH, h, d, 1, row0, R, k0, d, vec_h);
      load_chunk<T, BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
      __syncthreads();
      acc.mma(sH, sW);
      __syncthreads();
    }
    acc.store(sZ);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int rr = i / BN, j = i % BN, col = n0 + j;
      float dz = 0.f;
      if (row0 + rr < R && col < V) {
        const float z = capz(sZ[rr * ZLD + j], cap);
        const float L = s_lse[rr];
        const float p = expf(z - L);
        dz = s_glp[rr] * ((col == s_tgt[rr] ? 1.f : 0.f) - p)
             - s_gent[rr] * p * (z - L + s_ent[rr]);
        if (cap != 0.f) {
          const float t = z / cap;
          dz *= 1.f - t * t;
        }
      }
      sDz[rr * DZLD + j] = from_f<T>(dz);
    }
    __syncthreads();
    for (int k0 = kd0; k0 < kd1; k0 += BK) {
      load_chunk<T, BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
      __syncthreads();
      dh_chunk(sDz, sW, dacc + (k0 - kd0), dld);
      __syncthreads();
    }
  }
  float* out = dpart + (size_t)blockIdx.y * R * d;
  const int width = kd1 - kd0;
  for (int i = threadIdx.x; i < BM * width; i += kThreads) {
    const int rr = i / width, k = i % width;
    if (row0 + rr < R) out[(size_t)(row0 + rr) * d + kd0 + k] = dacc[rr * dld + k];
  }
}

// dh = sum over vocab slices of the partials, in slice order, cast to T.
template <typename T>
__global__ void tlp_bwd_reduce(const float* __restrict__ dpart, T* __restrict__ dh,
                               long long n, int vsplit) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < vsplit; ++v) s += dpart[(size_t)v * n + i];
    dh[i] = from_f<T>(s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
void vec_flags(const void* h, const void* w, int d, long long ws_k, long long ws_v,
               int* vec_h, int* vec_w) {
  constexpr int V = Tr<T>::VEC;
  *vec_h = aligned16(h) && d % V == 0;
  *vec_w = ws_k == 1 && aligned16(w) && ws_v % V == 0 && d % V == 0;
}

template <typename T>
cudaError_t fwd_t(const void* h, const void* w, const int* tgt, float4* part, float* lp,
                  float* ent, float* lse, int R, int d, int V, long long ws_k, long long ws_v,
                  int vsplit, int slice_tiles, float cap, cudaStream_t st) {
  int vh, vw;
  vec_flags<T>(h, w, d, ws_k, ws_v, &vh, &vw);
  tlp_fwd<T><<<dim3((R + BM_FWD - 1) / BM_FWD, vsplit), kThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), tgt, part, R, d, V, ws_k, ws_v,
      slice_tiles, cap, vh, vw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tlp_merge<<<(R + 255) / 256, 256, 0, st>>>(part, R, vsplit, lp, ent, lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const void* h, const void* w, const int* tgt, const float* lse,
                  const float* ent, const float* g_lp, const float* g_ent, float* dpart,
                  void* dh, int R, int d, int V, long long ws_k, long long ws_v, int vsplit,
                  int slice_tiles, int dch, float cap, cudaStream_t st) {
  static bool attr_set = false;
  const BwdSmem o = bwd_smem<T>(dch + 4);
  if (!attr_set) {
    // sized for the largest chunk the wrapper passes (1024 columns)
    cudaError_t err = cudaFuncSetAttribute(tlp_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bwd_smem<T>(1024 + 4).total);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  int vh, vw;
  vec_flags<T>(h, w, d, ws_k, ws_v, &vh, &vw);
  const int dsplit = (d + dch - 1) / dch;
  tlp_bwd<T><<<dim3((R + BM_BWD - 1) / BM_BWD, vsplit, dsplit), kThreads, o.total, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), tgt, lse, ent, g_lp, g_ent, dpart, R,
      d, V, ws_k, ws_v, slice_tiles, dch, cap, vh, vw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)R * d;
  const long long blocks = (n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048;
  tlp_bwd_reduce<T><<<(int)blocks, 256, 0, st>>>(dpart, static_cast<T*>(dh), n, vsplit);
  return cudaGetLastError();
}

bool bad_args(int R, int d, int V, int vsplit, int slice_tiles, int dtype) {
  const int n_tiles = (V + BN - 1) / BN;
  return R < 0 || d <= 0 || V <= 0 || vsplit < 1 || slice_tiles < 1 ||
         (long long)vsplit * slice_tiles < n_tiles || dtype < 0 || dtype > 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). tgt int32 [R] in [0, V);
// w[k, v] at w + k * ws_k + v * ws_v. part: [vsplit, R] float4 scratch;
// lp, ent, lse: [R] float32 outputs. Vocab slice s covers tiles
// [s * slice_tiles, (s + 1) * slice_tiles) of 64 columns.
extern "C" int token_logprob_fwd_launch(const void* h, const void* w, const void* tgt,
                                        void* part, void* lp, void* ent, void* lse, int R,
                                        int d, int V, long long ws_k, long long ws_v,
                                        int vsplit, int slice_tiles, float cap, int dtype,
                                        void* stream) {
  if (bad_args(R, d, V, vsplit, slice_tiles, dtype)) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tgt);
  float4* p = static_cast<float4*>(part);
  float* a = static_cast<float*>(lp);
  float* b = static_cast<float*>(ent);
  float* c = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)fwd_t<float>(h, w, t, p, a, b, c, R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap, st);
  return (int)fwd_t<bf16>(h, w, t, p, a, b, c, R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap, st);
}

// lse, ent: the forward's [R] float32; g_lp, g_ent: upstream grads [R] float32.
// dpart: [vsplit, R, d] float32 scratch; dh: [R, d] in h's dtype. dch: width
// of the d-chunk one block accumulates, a multiple of 32 up to 1024.
extern "C" int token_logprob_bwd_launch(const void* h, const void* w, const void* tgt,
                                        const void* lse, const void* ent, const void* g_lp,
                                        const void* g_ent, void* dpart, void* dh, int R, int d,
                                        int V, long long ws_k, long long ws_v, int vsplit,
                                        int slice_tiles, int dch, float cap, int dtype,
                                        void* stream) {
  if (bad_args(R, d, V, vsplit, slice_tiles, dtype) || dch <= 0 || dch > 1024 || dch % BK)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tgt);
  const float* ls = static_cast<const float*>(lse);
  const float* en = static_cast<const float*>(ent);
  const float* gl = static_cast<const float*>(g_lp);
  const float* ge = static_cast<const float*>(g_ent);
  float* dp = static_cast<float*>(dpart);
  if (dtype == 0)
    return (int)bwd_t<float>(h, w, t, ls, en, gl, ge, dp, dh, R, d, V, ws_k, ws_v, vsplit,
                             slice_tiles, dch, cap, st);
  return (int)bwd_t<bf16>(h, w, t, ls, en, gl, ge, dp, dh, R, d, V, ws_k, ws_v, vsplit,
                          slice_tiles, dch, cap, st);
}
