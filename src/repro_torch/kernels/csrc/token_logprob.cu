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
// What bounds it on an H100: the products. The forward is 2*R*d*V
// operations, the backward 4*R*d*V (the logits are recomputed, then
// dz @ W^T): at R = 624, d = 1024, V = 151936 that is 3.9e11 operations,
// 0.39 ms at 989 TFLOP/s bf16, against 0.09 ms to read W's 311 MB once.
// Below about R = 300 rows the bytes of W bound it instead.
//
// W comes with its two strides, so the tied [V, d] embedding is read as
// [d, V] in place (k contiguous) and an untied [d, V] head as it lies (v
// contiguous). The ragged last vocab tile is masked, so V need not divide by
// anything.
//
// bf16: every product runs on one tensor-core mainloop (mm_mainloop): 128 x
// 128 block tiles, 8 warps of 64 x 32, mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix, and a 4-stage ring of 16-byte cp.async copies
// (zero-filled past the ragged edges) in 80 KB of dynamic shared memory, so
// three K-steps of loads are in flight while one computes. W's tile is
// staged as it lies: k contiguous takes ldmatrix, v contiguous
// ldmatrix.trans, other strides plain loads. Row tiles are the fastest grid
// dimension, so the blocks that read one W tile run together and W comes
// from memory about once per product. No float atomics anywhere: every run
// gives the same bits.
//
// Forward, bf16 (tlp_fwd_mm; not the Pallas grid, which walks the vocab in
// sequence per row block and carries m, l, s in VMEM scratch): grid (row
// tiles, vocab slices), so a training micro-batch of a few hundred rows
// fills the card. A block walks its slice's 128-column tiles; per tile the
// mainloop runs over K = d and the epilogue works from the accumulators in
// registers: softcap, then per row the max and target logit over the 4
// lanes of a quad (shuffles), l = sum e^(z - max) and s = sum z e^(z - max)
// against that max (shuffles again), the 4 warps along N merged through 8
// KB of shared memory in a fixed order, and the tile folded into the row's
// running state. Columns past V are left out of every statistic (the zero
// fill would give them logit 0 and corrupt the lse).
// Each (slice, row) writes one float4 partial; a merge launch combines a
// row's slices in slice order.
//
// Forward, fp32 (the FMA path that holds the kernels to fp32 references):
// 64-row blocks walk 64-column tiles, h and W streamed through shared memory
// in 32-wide d-chunks, the logits tile through shared memory to two threads
// a row; partials and merge as in bf16.
//
// Backward, bf16: per vocab chunk of vc columns, two tiled products on the
// mainloop, so that W is read about once per product (not once per row
// block, as a fused kernel with a d-wide dh accumulator must) and dh stays
// in registers:
//  1. Z = h @ W[:, chunk]; the epilogue turns the fp32 accumulators into dz
//     (softcap, softmax and entropy terms from the forward's lse and ent),
//     rounds it to bf16 as a bf16 autograd would and writes it to a [R, vc]
//     scratch (0 past V).
//  2. part[s] (+)= dz @ W[:, chunk]^T, M = R, N = d, K = the chunk, K split
//     into S pieces so that a few hundred rows still fill the card; piece s
//     adds into its own fp32 partial [R, d], whose tile belongs to one block
//     per launch. Chunks run in order on the stream.
// A last launch sums the S partials in order and casts to bf16.
//
// Backward, fp32 (the FMA path): row blocks of 32, a [32, <=1024] fp32 dh
// accumulator in shared memory; per 64-column vocab tile the block
// recomputes the logits, forms dz and adds dz @ W_tile^T into the
// accumulator; each vocab slice writes a partial dh and a reduce launch sums
// the slices in order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // 4 warps per fp32 block
constexpr int BN = 64;            // fp32: vocab columns per tile
constexpr int BK = 32;            // fp32: d-chunk streamed through shared memory
constexpr int BM_FWD = 64;        // fp32: rows per forward block
constexpr int BM_BWD = 32;        // fp32: rows per backward block
constexpr int ZLD = BN + 4;       // row stride of the fp32 logits tile
constexpr int CLD = BK + 1;       // fp32 chunk row stride: odd, keeps banks apart
constexpr int DZLD = BN + 1;      // row stride of the fp32 dz tile
constexpr int VEC = 4;            // floats per 16-byte load
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float capz(float z, float cap) {
  return cap != 0.f ? tanhf(z / cap) * cap : z;
}

// dz of one logit (see the note at the top); z is already softcapped.
__device__ __forceinline__ float dz_of(float z, bool hit, float lse, float ent, float g_lp,
                                       float g_ent, float cap) {
  const float p = expf(z - lse);
  float dz = g_lp * ((hit ? 1.f : 0.f) - p) - g_ent * p * (z - lse + ent);
  if (cap != 0.f) {
    const float t = z / cap;
    dz *= 1.f - t * t;
  }
  return dz;
}

// Two rows' (or row pieces') statistics (m, l, s, target logit) as one: a
// fixed order of operations, so the same inputs give the same bits.
__device__ __forceinline__ float4 merge_stats(float4 a, float4 b) {
  const float mn = fmaxf(a.x, b.x);
  const float ea = expf(a.x - mn), eb = expf(b.x - mn);
  return make_float4(mn, a.y * ea + b.y * eb, a.z * ea + b.z * eb, fmaxf(a.w, b.w));
}

// ---------------------------------------------------------------------------
// fp32: forward and backward on the FMA units
// ---------------------------------------------------------------------------

// dst[r * CLD + k] = src[(r0 + r) * s_r + (k0 + k) * s_k] for r < ROWS, k < BK;
// zero outside r0 + r < r_lim, k0 + k < k_lim. `vec`: s_k == 1, rows and base
// 16-byte aligned and k_lim a multiple of VEC, so a vector is all in or out.
template <int ROWS>
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ src,
                                           long long s_r, long long s_k, int r0, int r_lim,
                                           int k0, int k_lim, bool vec) {
  if (vec) {
    constexpr int PER_ROW = BK / VEC;
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, k = (i % PER_ROW) * VEC;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < r_lim && k0 + k < k_lim)
        u = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * s_r + (k0 + k));
      float* d = dst + r * CLD + k;
      d[0] = u.x;
      d[1] = u.y;
      d[2] = u.z;
      d[3] = u.w;
    }
  } else if (s_k == 1) {          // k contiguous: neighbouring threads along k
    for (int i = threadIdx.x; i < ROWS * BK; i += kThreads) {
      const int r = i / BK, k = i % BK;
      float x = 0.f;
      if (r0 + r < r_lim && k0 + k < k_lim) x = src[(size_t)(r0 + r) * s_r + (k0 + k)];
      dst[r * CLD + k] = x;
    }
  } else {                        // rows contiguous: neighbouring threads along r
    for (int i = threadIdx.x; i < ROWS * BK; i += kThreads) {
      const int r = i % ROWS, k = i / ROWS;
      float x = 0.f;
      if (r0 + r < r_lim && k0 + k < k_lim)
        x = src[(size_t)(r0 + r) * s_r + (size_t)(k0 + k) * s_k];
      dst[r * CLD + k] = x;
    }
  }
}

// Logits tile accumulator: [BM, BN] += sH[BM, BK] . sW[BN, BK]^T over
// chunks; thread (tr, tc) owns rows tr + 8i and columns tc + 16j.
template <int BM> struct ZAcc {
  static constexpr int RI = BM / 8;
  float c[RI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ __forceinline__ void mma(const float* sH, const float* sW) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[(tc + 16 * j) * CLD + k];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = sH[(tr + 8 * i) * CLD + k];
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

// fp32 backward: acc[BM_BWD, BK] += sDz[BM_BWD, BN] . sW[BN, BK] (sW holds
// W^T's chunk: element (n, k) = W[k0 + k, n0 + n]); acc is a chunk of the
// shared dh accumulator with row stride dld.
__device__ __forceinline__ void dh_chunk(const float* sDz, const float* sW, float* acc, int dld) {
  const int k = threadIdx.x % 32, rg = threadIdx.x / 32;
  float c[BM_BWD / 4];
#pragma unroll
  for (int i = 0; i < BM_BWD / 4; ++i) c[i] = 0.f;
#pragma unroll 4
  for (int n = 0; n < BN; ++n) {
    const float b = sW[n * CLD + k];
#pragma unroll
    for (int i = 0; i < BM_BWD / 4; ++i) c[i] = fmaf(sDz[(rg + 4 * i) * DZLD + n], b, c[i]);
  }
#pragma unroll
  for (int i = 0; i < BM_BWD / 4; ++i) acc[(rg + 4 * i) * dld + k] += c[i];
}

__global__ void __launch_bounds__(kThreads)
tlp_fwd(const float* __restrict__ h, const float* __restrict__ w, const int* __restrict__ tgt,
        float4* __restrict__ part, int R, int d, int V, long long ws_k, long long ws_v,
        int slice_tiles, float cap, int vec_h, int vec_w) {
  constexpr int BM = BM_FWD;
  constexpr int TPR = kThreads / BM;              // threads per row for the statistics
  __shared__ __align__(128) float sH[BM * CLD];
  __shared__ __align__(128) float sW[BN * CLD];
  __shared__ __align__(128) float sZ[BM * ZLD];

  const int row0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int t0 = blockIdx.y * slice_tiles;
  const int t1 = min(n_tiles, t0 + slice_tiles);
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int grow = row0 + r;
  const int target = grow < R ? tgt[grow] : -1;
  float m = kNegInf, l = 0.f, s = 0.f, tv = kNegInf;
  ZAcc<BM> acc;

  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    acc.zero();
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_chunk<BM>(sH, h, d, 1, row0, R, k0, d, vec_h);
      load_chunk<BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
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
  // the TPR threads of a row merge their partials (xor pairs)
  float4 st = make_float4(m, l, s, tv);
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float4 o = make_float4(__shfl_xor_sync(0xffffffffu, st.x, off),
                                 __shfl_xor_sync(0xffffffffu, st.y, off),
                                 __shfl_xor_sync(0xffffffffu, st.z, off),
                                 __shfl_xor_sync(0xffffffffu, st.w, off));
    st = merge_stats(st, o);
  }
  if (sub == 0 && grow < R) part[(size_t)blockIdx.y * R + grow] = st;
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
// backward, fp32
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t round128(size_t b) { return (b + 127) & ~(size_t)127; }

struct BwdSmem {                  // byte offsets into the dynamic shared memory
  size_t w, z, dz, row, acc, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int dld) {
  BwdSmem o;
  o.w = round128(sizeof(float) * BM_BWD * CLD);
  o.z = o.w + round128(sizeof(float) * BN * CLD);
  o.dz = o.z + round128(sizeof(float) * BM_BWD * ZLD);
  o.row = o.dz + round128(sizeof(float) * BM_BWD * DZLD);
  o.acc = o.row + round128(sizeof(float) * 5 * BM_BWD);
  o.total = o.acc + round128(sizeof(float) * (size_t)BM_BWD * dld);
  return o;
}

__global__ void __launch_bounds__(kThreads)
tlp_bwd_f32(const float* __restrict__ h, const float* __restrict__ w,
            const int* __restrict__ tgt, const float* __restrict__ lse,
            const float* __restrict__ ent, const float* __restrict__ g_lp,
            const float* __restrict__ g_ent, float* __restrict__ dpart, int R, int d, int V,
            long long ws_k, long long ws_v, int slice_tiles, int dch, float cap, int vec_h,
            int vec_w) {
  constexpr int BM = BM_BWD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dld = dch + 4;
  const BwdSmem o = bwd_smem(dld);
  float* sH = reinterpret_cast<float*>(smem);
  float* sW = reinterpret_cast<float*>(smem + o.w);
  float* sZ = reinterpret_cast<float*>(smem + o.z);
  float* sDz = reinterpret_cast<float*>(smem + o.dz);
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

  ZAcc<BM> acc;
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    acc.zero();
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_chunk<BM>(sH, h, d, 1, row0, R, k0, d, vec_h);
      load_chunk<BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
      __syncthreads();
      acc.mma(sH, sW);
      __syncthreads();
    }
    acc.store(sZ);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int rr = i / BN, j = i % BN, col = n0 + j;
      float dz = 0.f;
      if (row0 + rr < R && col < V)
        dz = dz_of(capz(sZ[rr * ZLD + j], cap), col == s_tgt[rr], s_lse[rr], s_ent[rr],
                   s_glp[rr], s_gent[rr], cap);
      sDz[rr * DZLD + j] = dz;
    }
    __syncthreads();
    for (int k0 = kd0; k0 < kd1; k0 += BK) {
      load_chunk<BN>(sW, w, ws_v, ws_k, n0, V, k0, d, vec_w);
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

// dh = sum over the partials (vocab slices, or K-splits), in order, cast to T.
template <typename T>
__global__ void tlp_bwd_reduce(const float* __restrict__ dpart, T* __restrict__ dh,
                               long long n, int nparts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < nparts; ++v) s += dpart[(size_t)v * n + i];
    dh[i] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core mainloop of every product
// ---------------------------------------------------------------------------

constexpr int TM = 128, TN = 128, TK = 32;   // block tile and K-step of every product
constexpr int kStages = 4;                   // depth of the cp.async ring
constexpr int kMmThreads = 256;              // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int A_LD = TK + 8;                 // A staged [TM][TK]: 80-byte rows, so the 8
                                             // rows of an ldmatrix hit distinct banks
constexpr int BK_LD = TK + 8;                // B staged [TN][TK] (k contiguous)
constexpr int BN_LD = TN + 8;                // B staged [TK][TN] (n contiguous), 272-byte rows
constexpr int A_STAGE = TM * A_LD;           // elements per stage
constexpr int B_STAGE = TN * BK_LD > TK * BN_LD ? TN * BK_LD : TK * BN_LD;
constexpr int MM_SMEM = kStages * (A_STAGE + B_STAGE) * (int)sizeof(bf16);   // 80 KB

// An operand of a tiled product: element (i, k) at p[i * si + k * sk] for
// i < rows, k < K, zero outside. vec: the contiguous dimension takes 16-byte
// copies (base 16-byte aligned, the other stride and the contiguous extent
// multiples of 8), so an 8-element vector is all in or all out.
struct Opnd {
  const bf16* p;
  long long si, sk;
  int rows, K, vec;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [i0, i0 + ROWS) x k [k0, k0 + TK) of an operand whose k is
// contiguous as s[r * (TK + 8) + k].
template <int ROWS>
__device__ __forceinline__ void stage_k(bf16* s, const Opnd& o, int i0, int k0) {
  constexpr int LD = TK + 8;
  if (o.vec) {
    for (int c = threadIdx.x; c < ROWS * (TK / 8); c += kMmThreads) {
      const int r = c / (TK / 8), k = (c % (TK / 8)) * 8;
      const bool ok = i0 + r < o.rows && k0 + k < o.K;
      cp_async16(s + r * LD + k, ok ? o.p + (i0 + r) * o.si + (k0 + k) : o.p, ok);
    }
  } else {                        // neighbouring threads along k
    for (int e = threadIdx.x; e < ROWS * TK; e += kMmThreads) {
      const int r = e / TK, k = e % TK;
      const bool ok = i0 + r < o.rows && k0 + k < o.K;
      s[r * LD + k] = ok ? o.p[(i0 + r) * o.si + (k0 + k) * o.sk] : __float2bfloat16(0.f);
    }
  }
}

// The same for an operand whose i is contiguous, as s[k * (ROWS + 8) + r].
template <int ROWS>
__device__ __forceinline__ void stage_i(bf16* s, const Opnd& o, int i0, int k0) {
  constexpr int LD = ROWS + 8;
  if (o.vec) {
    for (int c = threadIdx.x; c < TK * (ROWS / 8); c += kMmThreads) {
      const int k = c / (ROWS / 8), r = (c % (ROWS / 8)) * 8;
      const bool ok = i0 + r < o.rows && k0 + k < o.K;
      cp_async16(s + k * LD + r, ok ? o.p + (i0 + r) + (k0 + k) * o.sk : o.p, ok);
    }
  } else {                        // neighbouring threads along i
    for (int e = threadIdx.x; e < TK * ROWS; e += kMmThreads) {
      const int k = e / ROWS, r = e % ROWS;
      const bool ok = i0 + r < o.rows && k0 + k < o.K;
      s[k * LD + r] = ok ? o.p[(i0 + r) * o.si + (k0 + k) * o.sk] : __float2bfloat16(0.f);
    }
  }
}

// acc[TM x TN tile at (m0, n0)] = sum over k in [k0, k1) of A(m, k) B(n, k).
// A's k is contiguous; B's k is contiguous when B_K (ldmatrix), its n
// otherwise (ldmatrix.trans). Warp w owns rows (w / 4) * 64 .. +64 and
// columns (w % 4) * 32 .. +32: acc[mi][nj] is the 16 x 8 block at row
// 16 mi, column 8 nj of that, in mma.sync's accumulator layout.
template <bool B_K>
__device__ __forceinline__ void mm_mainloop(float (&acc)[4][4][4], const Opnd& A, const Opnd& B,
                                            int m0, int n0, int k0, int k1, bf16* smem) {
  bf16* sA = smem;
  bf16* sB = smem + kStages * A_STAGE;
  const int nk = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;
  auto load = [&](int kt) {
    const int st = kt % kStages, k = k0 + kt * TK;
    stage_k<TM>(sA + st * A_STAGE, A, m0, k);
    if (B_K)
      stage_k<TN>(sB + st * B_STAGE, B, n0, k);
    else
      stage_i<TN>(sB + st * B_STAGE, B, n0, k);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();            // one group per K-step, empty ones included
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // step kt has landed (for this thread) ...
    __syncthreads();                // ... for all, and step kt - 1's stage is free
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const bf16* a_s = sA + (kt % kStages) * A_STAGE;
    const bf16* b_s = sB + (kt % kStages) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], a_s + (wm + mi * 16 + (lane & 15)) * A_LD + ks + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned r[4];            // n-blocks 2p and 2p+1, k halves 0 and 1
        if (B_K)
          ldsm_x4(r, b_s + (wn + p * 16 + (lane >> 4) * 8 + (lane & 7)) * BK_LD + ks +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(r, b_s + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BN_LD + wn + p * 16 +
                           (lane >> 4) * 8);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// forward, bf16: the logits product with an online-softmax epilogue
// ---------------------------------------------------------------------------

// The statistics of rows [m0, m0 + TM) over the 128-column vocab tiles
// [t0, t1) of slice s = blockIdx.y, written as part[s * R + row]. A = h
// [R, d]; B(n = v, k = j) = W[j, v], rows = V; B_K: W's k is contiguous.
template <bool B_K>
__global__ void __launch_bounds__(kMmThreads, 2)
tlp_fwd_mm(Opnd A, Opnd B, const int* __restrict__ tgt, float4* __restrict__ part,
           int slice_tiles, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float4 sRed[4][TM];  // per warp along N, per row of the tile
  __shared__ float4 sRun[TM];     // each row's running statistics (thread r's row r:
  __shared__ int sTgt[TM];        // no registers held across the mainloop)
  const int R = A.rows, V = B.rows;
  const int m0 = blockIdx.x * TM;
  const int t0 = blockIdx.y * slice_tiles;
  const int t1 = min((V + TN - 1) / TN, t0 + slice_tiles);
  for (int i = threadIdx.x; i < TM; i += kMmThreads) {
    sTgt[i] = m0 + i < R ? tgt[m0 + i] : -1;
    sRun[i] = make_float4(kNegInf, 0.f, 0.f, kNegInf);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wq = warp & 3;
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * TN;
    float acc[4][4][4] = {};
    mm_mainloop<B_K>(acc, A, B, m0, n0, 0, A.K, reinterpret_cast<bf16*>(smem));
    // this thread's 8 columns of each of its rows: j -> acc[.][j / 2][. + j % 2],
    // column c0 + (j / 2) * 8 + j % 2; those at or past V - c0 lie past V,
    // zero-filled, and enter no statistic. The 4 lanes of a quad hold a
    // row's 32 columns of this warp: first their max and target logit, then
    // l and s against that max, each combined over the quad by shuffles.
    const int c0 = n0 + wq * 32 + (lane & 3) * 2, past = V - c0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm + mi * 16 + (lane >> 2) + 8 * hf;      // row in the tile
        const int t = sTgt[r] - c0;
        float mx = kNegInf, tv = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& z = acc[mi][j >> 1][2 * hf + (j & 1)];
          z = capz(z, cap);
          const int c = (j >> 1) * 8 + (j & 1);
          if (c < past) {
            mx = fmaxf(mx, z);
            if (c == t) tv = z;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          tv = fmaxf(tv, __shfl_xor_sync(0xffffffffu, tv, off));
        }
        float l = 0.f, sz = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float z = acc[mi][j >> 1][2 * hf + (j & 1)];
          if ((j >> 1) * 8 + (j & 1) < past) {
            const float p = expf(z - mx);
            l += p;
            sz += p * z;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l += __shfl_xor_sync(0xffffffffu, l, off);
          sz += __shfl_xor_sync(0xffffffffu, sz, off);
        }
        if ((lane & 3) == 0) sRed[wq][r] = make_float4(mx, l, sz, tv);
      }
    // sRed is complete, and no warp still reads the ring, which the next
    // tile's first loads overwrite
    __syncthreads();
    if (threadIdx.x < TM) {
      float4 st = sRed[0][threadIdx.x];
#pragma unroll
      for (int q = 1; q < 4; ++q) st = merge_stats(st, sRed[q][threadIdx.x]);
      sRun[threadIdx.x] = merge_stats(sRun[threadIdx.x], st);
    }
    // the next write of sRed follows the next mainloop's first barrier
  }
  if (threadIdx.x < TM && m0 + (int)threadIdx.x < R)
    part[(size_t)blockIdx.y * R + m0 + threadIdx.x] = sRun[threadIdx.x];
}

// ---------------------------------------------------------------------------
// backward, bf16: the two tiled products
// ---------------------------------------------------------------------------

// What product 1's epilogue needs to turn logits into dz.
struct DzArgs {
  const int* tgt;
  const float *lse, *ent, *g_lp, *g_ent;
  bf16* dz;                       // [R, ldz] chunk scratch
  int ldz, R, v0, V;              // v0: the chunk's first vocab column
  float cap;
};

// Product 1: dz[:, tile] of Z = h @ W[:, chunk]. Grid (row tiles, vocab tiles
// of the chunk): row tiles fastest, so the blocks that read one W tile run
// together. B_K: W's k is contiguous (the tied embedding's transpose).
template <bool B_K>
__global__ void __launch_bounds__(kMmThreads, 2)
tlp_bwd_logits(Opnd A, Opnd B, DzArgs e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  float acc[4][4][4] = {};
  mm_mainloop<B_K>(acc, A, B, m0, n0, 0, A.K, reinterpret_cast<bf16*>(smem));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm + mi * 16 + (lane >> 2) + 8 * hf;
      if (r >= e.R) continue;
      const float L = e.lse[r], En = e.ent[r], gl = e.g_lp[r], ge = e.g_ent[r];
      const int t = e.tgt[r];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int c = n0 + wn + nj * 8 + (lane & 3) * 2;     // column in the chunk
        float out[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int v = e.v0 + c + q;
          out[q] = v < e.V ? dz_of(capz(acc[mi][nj][2 * hf + q], e.cap), v == t, L, En, gl, ge,
                                   e.cap)
                           : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(e.dz + (size_t)r * e.ldz + c) =
            __floats2bfloat162_rn(out[0], out[1]);
      }
    }
}

// Product 2: part[s] (+)= dz @ W[:, chunk]^T over the chunk's K piece
// [s * piece, (s + 1) * piece), s = blockIdx.z. Grid (row tiles, d tiles,
// pieces). B_K: W's v is contiguous (an untied [d, V] head). `add`: add into
// the partial (every chunk after the first) instead of writing it.
template <bool B_K>
__global__ void __launch_bounds__(kMmThreads, 2)
tlp_bwd_dh(Opnd A, Opnd B, float* __restrict__ part, int R, int d, int piece, int add) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int k0 = blockIdx.z * piece, k1 = min(A.K, k0 + piece);
  float acc[4][4][4] = {};
  mm_mainloop<B_K>(acc, A, B, m0, n0, k0, k1, reinterpret_cast<bf16*>(smem));
  float* out = part + (size_t)blockIdx.z * R * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + wm + mi * 16 + (lane >> 2) + 8 * hf;
      if (r >= R) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = n0 + wn + nj * 8 + (lane & 3) * 2 + q;
          if (c >= d) continue;
          float* o = out + (size_t)r * d + c;
          *o = add ? *o + acc[mi][nj][2 * hf + q] : acc[mi][nj][2 * hf + q];
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

void vec_flags(const void* h, const void* w, int d, long long ws_k, long long ws_v, int* vec_h,
               int* vec_w) {
  *vec_h = aligned16(h) && d % VEC == 0;
  *vec_w = ws_k == 1 && aligned16(w) && ws_v % VEC == 0 && d % VEC == 0;
}

template <typename K>
cudaError_t allow_mm_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
}

cudaError_t merge_parts(const float4* part, float* lp, float* ent, float* lse, int R, int vsplit,
                        cudaStream_t st, int* launched) {
  tlp_merge<<<(R + 255) / 256, 256, 0, st>>>(part, R, vsplit, lp, ent, lse);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

cudaError_t fwd_f32(const float* h, const float* w, const int* tgt, float4* part, float* lp,
                    float* ent, float* lse, int R, int d, int V, long long ws_k, long long ws_v,
                    int vsplit, int slice_tiles, float cap, cudaStream_t st, int* launched,
                    int* w_vector) {
  int vh, vw;
  vec_flags(h, w, d, ws_k, ws_v, &vh, &vw);
  tlp_fwd<<<dim3((R + BM_FWD - 1) / BM_FWD, vsplit), kThreads, 0, st>>>(
      h, w, tgt, part, R, d, V, ws_k, ws_v, slice_tiles, cap, vh, vw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  *w_vector += vw;
  return merge_parts(part, lp, ent, lse, R, vsplit, st, launched);
}

cudaError_t fwd_bf16(const bf16* h, const bf16* w, const int* tgt, float4* part, float* lp,
                     float* ent, float* lse, int R, int d, int V, long long ws_k, long long ws_v,
                     int vsplit, int slice_tiles, float cap, cudaStream_t st, int* launched,
                     int* w_vector) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = allow_mm_smem(tlp_fwd_mm<true>);
    if (err == cudaSuccess) err = allow_mm_smem(tlp_fwd_mm<false>);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  // W staged with k contiguous (ldmatrix) unless its v stride is the smaller
  // (ldmatrix.trans); 16-byte copies only where the contiguous stride is 1
  const bool b_k = ws_k <= ws_v;
  const Opnd A{h, d, 1, R, d, aligned16(h) && d % 8 == 0};
  const int wvec = aligned16(w) && (b_k ? ws_k == 1 && ws_v % 8 == 0 && d % 8 == 0
                                        : ws_v == 1 && ws_k % 8 == 0 && V % 8 == 0);
  const Opnd B{w, ws_v, ws_k, V, d, wvec};
  const dim3 grid((R + TM - 1) / TM, vsplit);
  if (b_k)
    tlp_fwd_mm<true><<<grid, kMmThreads, MM_SMEM, st>>>(A, B, tgt, part, slice_tiles, cap);
  else
    tlp_fwd_mm<false><<<grid, kMmThreads, MM_SMEM, st>>>(A, B, tgt, part, slice_tiles, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  *w_vector += wvec;
  return merge_parts(part, lp, ent, lse, R, vsplit, st, launched);
}

template <typename T>
cudaError_t reduce_parts(const float* part, T* dh, int R, int d, int nparts, cudaStream_t st,
                         int* launched) {
  const long long n = (long long)R * d;
  const long long blocks = (n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048;
  tlp_bwd_reduce<T><<<(int)blocks, 256, 0, st>>>(part, dh, n, nparts);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

cudaError_t bwd_f32(const float* h, const float* w, const int* tgt, const float* lse,
                    const float* ent, const float* g_lp, const float* g_ent, float* dpart,
                    float* dh, int R, int d, int V, long long ws_k, long long ws_v, int vsplit,
                    int slice_tiles, float cap, cudaStream_t st, int* launched,
                    int* w_vector) {
  static bool attr_set = false;
  const int dch = d < 1024 ? (d + BK - 1) / BK * BK : 1024;   // dh columns per block
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(tlp_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bwd_smem(1024 + 4).total);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  int vh, vw;
  vec_flags(h, w, d, ws_k, ws_v, &vh, &vw);
  const int dsplit = (d + dch - 1) / dch;
  tlp_bwd_f32<<<dim3((R + BM_BWD - 1) / BM_BWD, vsplit, dsplit), kThreads,
                bwd_smem(dch + 4).total, st>>>(h, w, tgt, lse, ent, g_lp, g_ent, dpart, R, d, V,
                                               ws_k, ws_v, slice_tiles, dch, cap, vh, vw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  *w_vector += vw;
  return reduce_parts(dpart, dh, R, d, vsplit, st, launched);
}

cudaError_t bwd_bf16(const bf16* h, const bf16* w, const int* tgt, const float* lse,
                     const float* ent, const float* g_lp, const float* g_ent, bf16* dz,
                     float* part, bf16* dh, int R, int d, int V, long long ws_k, long long ws_v,
                     int vc, int splits, int piece, float cap, cudaStream_t st,
                     int* launched, int* w_vector) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = allow_mm_smem(tlp_bwd_logits<true>);
    if (err == cudaSuccess) err = allow_mm_smem(tlp_bwd_logits<false>);
    if (err == cudaSuccess) err = allow_mm_smem(tlp_bwd_dh<true>);
    if (err == cudaSuccess) err = allow_mm_smem(tlp_bwd_dh<false>);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const bool k_contig = ws_k == 1;       // the tied embedding's transpose
  const Opnd A1{h, d, 1, R, d, aligned16(h) && d % 8 == 0};
  for (int v0 = 0; v0 < V; v0 += vc) {
    const int kc = min(vc, V - v0);                  // the chunk's vocab columns
    const int kpad = (kc + TN - 1) / TN * TN;        // ... as whole tiles
    const bf16* wc = w + (long long)v0 * ws_v;
    const int wvec = aligned16(wc) && (k_contig ? ws_v % 8 == 0 && d % 8 == 0
                                                : ws_k % 8 == 0 && kc % 8 == 0);
    // product 1: B(n = v, k = j) = W[j, v0 + v]
    const Opnd B1{wc, ws_v, ws_k, kc, d, wvec};
    const DzArgs e{tgt, lse, ent, g_lp, g_ent, dz, vc, R, v0, V, cap};
    const dim3 g1((R + TM - 1) / TM, kpad / TN);
    if (k_contig)
      tlp_bwd_logits<true><<<g1, kMmThreads, MM_SMEM, st>>>(A1, B1, e);
    else
      tlp_bwd_logits<false><<<g1, kMmThreads, MM_SMEM, st>>>(A1, B1, e);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    // product 2: A = dz [R, kpad]; B(n = j, k = v) = W[j, v0 + v]
    const Opnd A2{dz, vc, 1, R, kpad, 1};
    const Opnd B2{wc, ws_k, ws_v, d, kc, wvec};
    const dim3 g2((R + TM - 1) / TM, (d + TN - 1) / TN, splits);
    if (k_contig)
      tlp_bwd_dh<false><<<g2, kMmThreads, MM_SMEM, st>>>(A2, B2, part, R, d, piece, v0 > 0);
    else
      tlp_bwd_dh<true><<<g2, kMmThreads, MM_SMEM, st>>>(A2, B2, part, R, d, piece, v0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    *w_vector += wvec;
  }
  return reduce_parts(part, dh, R, d, splits, st, launched);
}

// tile: the vocab columns per tile of the kernel the slices are cut for
bool bad_args(int R, int d, int V, int vsplit, int slice_tiles, int tile) {
  const int n_tiles = (V + tile - 1) / tile;
  return R < 0 || d <= 0 || V <= 0 || vsplit < 1 || vsplit > 65535 || slice_tiles < 1 ||
         (long long)vsplit * slice_tiles < n_tiles;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w share it). tgt int32 [R] in [0, V);
// w[k, v] at w + k * ws_k + v * ws_v, any positive strides. part: [vsplit, R]
// float4 scratch; lp, ent, lse: [R] float32 outputs. Vocab slice s covers
// tiles [s * slice_tiles, (s + 1) * slice_tiles) of 64 columns (float32) or
// 128 (bfloat16). Each launcher adds one to *launched (a host int) for every
// kernel it launches, and one to *w_vector (a host int) for every vocab chunk
// whose W tiles it loads by 16-byte copies (the forward and the fp32 backward
// have one chunk; the rest load W element by element).
extern "C" int token_logprob_fwd_launch(const void* h, const void* w, const void* tgt,
                                        void* part, void* lp, void* ent, void* lse, int R,
                                        int d, int V, long long ws_k, long long ws_v,
                                        int vsplit, int slice_tiles, float cap, int dtype,
                                        void* stream, int* launched, int* w_vector) {
  if (dtype < 0 || dtype > 1 || bad_args(R, d, V, vsplit, slice_tiles, dtype ? TN : BN))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tgt);
  float4* p = static_cast<float4*>(part);
  float* a = static_cast<float*>(lp);
  float* b = static_cast<float*>(ent);
  float* c = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)fwd_f32(static_cast<const float*>(h), static_cast<const float*>(w), t, p, a, b,
                        c, R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap, st, launched,
                        w_vector);
  return (int)fwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w), t, p, a, b, c,
                       R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap, st, launched,
                       w_vector);
}

// The fp32 backward. lse, ent: the forward's [R] float32; g_lp, g_ent:
// upstream grads [R] float32. dpart: [vsplit, R, d] float32 scratch; dh:
// [R, d] float32. Vocab slices as in the forward.
extern "C" int token_logprob_bwd_f32_launch(const void* h, const void* w, const void* tgt,
                                            const void* lse, const void* ent, const void* g_lp,
                                            const void* g_ent, void* dpart, void* dh, int R,
                                            int d, int V, long long ws_k, long long ws_v,
                                            int vsplit, int slice_tiles, float cap,
                                            void* stream, int* launched, int* w_vector) {
  if (bad_args(R, d, V, vsplit, slice_tiles, BN)) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  return (int)bwd_f32(static_cast<const float*>(h), static_cast<const float*>(w),
                      static_cast<const int*>(tgt), static_cast<const float*>(lse),
                      static_cast<const float*>(ent), static_cast<const float*>(g_lp),
                      static_cast<const float*>(g_ent), static_cast<float*>(dpart),
                      static_cast<float*>(dh), R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap,
                      static_cast<cudaStream_t>(stream), launched, w_vector);
}

// The bf16 backward. w's k or v stride must be 1. Vocab chunks of vc
// columns (a multiple of 128); dz: [R, vc] bf16 scratch; the dz @ W^T
// product of a chunk splits its K into `splits` pieces of `piece` columns (a
// multiple of 32, splits * piece >= vc); part: [splits, R, d] float32
// scratch; dh: [R, d] bf16. Other arguments as in the fp32 backward.
extern "C" int token_logprob_bwd_bf16_launch(const void* h, const void* w, const void* tgt,
                                             const void* lse, const void* ent, const void* g_lp,
                                             const void* g_ent, void* dz, void* part, void* dh,
                                             int R, int d, int V, long long ws_k,
                                             long long ws_v, int vc, int splits, int piece,
                                             float cap, void* stream, int* launched,
                                             int* w_vector) {
  if (R < 0 || d <= 0 || V <= 0 || vc <= 0 || vc % TN || splits < 1 || splits > 65535 ||
      piece <= 0 || piece % TK || (long long)splits * piece < vc || (ws_k != 1 && ws_v != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  return (int)bwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                       static_cast<const int*>(tgt), static_cast<const float*>(lse),
                       static_cast<const float*>(ent), static_cast<const float*>(g_lp),
                       static_cast<const float*>(g_ent), static_cast<bf16*>(dz),
                       static_cast<float*>(part), static_cast<bf16*>(dh), R, d, V, ws_k, ws_v,
                       vc, splits, piece, cap, static_cast<cudaStream_t>(stream), launched,
                       w_vector);
}
