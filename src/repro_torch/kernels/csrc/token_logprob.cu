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
// Below about R = 300 rows the bytes of W bound it instead. Only wgmma
// reaches the tensor cores' full rate (Ampere's warp-level products, fed
// from shared memory a fragment at a time, stayed near a fifth of it), and
// wgmma at that rate needs its tiles in shared memory sooner than threads
// that both copy and compute, meeting at a block barrier every K-step, can
// put them there.
//
// W comes with its two strides, so the tied [V, d] embedding is read as
// [d, V] in place (k contiguous) and an untied [d, V] head as it lies (v
// contiguous). The ragged edges are zero-filled and masked, so R, d and V
// need not divide by anything.
//
// bf16: every product runs on one warp-specialised mainloop (tlp_mm, its
// loop in mma_tile): 128 x 128 block tiles, three warpgroups, one block of
// 225 KB an SM. Warpgroup 2 produces: its first thread keeps TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle, zeros past the tensor's extents)
// of 64-deep K-steps in flight into a ring of 6 stages of 32 KB, each stage
// with a full and an empty mbarrier. Warpgroups 0 and 1 consume with wgmma
// m64n128k16 (bf16 in, fp32 accumulate in registers) straight from the
// swizzled tiles; a B tile whose n is contiguous (the untied head in the
// logits, the tied table in dz @ W^T) goes through the descriptor's
// transpose bit. setmaxnreg moves the producer's registers to the
// consumers. After set-up nothing waits on the whole block: the producer
// runs ahead into the next tile's loads while the consumers run an
// epilogue. Row tiles are the fastest grid dimension, so the blocks that
// read one W tile run together and W comes from memory about once per
// product. A W whose address or row stride TMA cannot take (a row of 512412
// bytes, an odd stride, a view with no unit stride) is fed by the
// producer's four warps instead, each filling every fourth stage: cp.async
// into the same swizzled layout, 16, 8 or 4 bytes a copy as the base and row
// stride allow (2-byte loads where they allow none), awaited, fenced to the
// async proxy and announced on the stage's full barrier. The wrapper picks
// W's route (token_logprob.py, w_feed) and the launchers check it. No float
// atomics anywhere: every run gives the same bits.
//
// The products whose epilogue does work per element, the forward's logits
// and the backward's dz, run their two consumers in ping-pong: each takes
// every other tile of the block, all 128 rows of it, and they take turns at
// the tensor cores, so that one's epilogue runs while the other's products
// do. The dz @ W^T product has one long tile a block and no such epilogue:
// its consumers share the tile, 64 rows each. An epilogue is held to a few
// instructions an element (the softcap and the masks of a ragged edge only
// where they apply, exp2 on the SFU, each lane's statistics merged over its
// quad once at the end): with its per-element branches it cost as much as
// the products themselves.
//
// Forward, bf16 (tlp_mm<kFwd>; not the Pallas grid, which walks the vocab in
// sequence per row block and carries m, l, s in VMEM scratch): grid (row
// tiles, vocab slices), so a training micro-batch of a few hundred rows
// fills the card. A block walks its slice's 128-column tiles. In wgmma's
// accumulator layout a warp holds 16 whole rows of each 64-row half, a row's
// 128 columns on the 4 lanes of a quad; per tile and row each lane takes
// the max of its 32 columns, l = sum e^(z - max) and s = sum z e^(z - max)
// against it, and the target logit where it holds the target, and folds
// them into its running (m, l, s, target logit) in registers. At the end
// the quad's lanes and the two consumers' shares merge in a fixed order.
// Columns past V are left out of every statistic (the zero fill would give
// them logit 0 and corrupt the lse). Each (slice, row) writes one float4
// partial; a merge launch combines a row's slices in slice order.
//
// Forward, fp32 (the FMA path that holds the kernels to fp32 references):
// 64-row blocks walk 64-column tiles, h and W streamed through shared memory
// in 32-wide d-chunks, the logits tile through shared memory to two threads
// a row; partials and merge as in bf16.
//
// Backward, bf16: per vocab chunk of vc columns, two products on the
// mainloop, so that W is read about once per product (not once per row
// block, as a fused kernel with a d-wide dh accumulator must) and dh stays
// in registers:
//  1. Z = h @ W[:, chunk] (tlp_mm<kDz>, blocks walking the chunk's tiles as
//     the forward's walk a slice); the epilogue turns the fp32 accumulators
//     into dz (softcap, softmax and entropy terms from the forward's lse and
//     ent), rounds it to bf16 as a bf16 autograd would and writes it to a
//     [R, vc] scratch (0 past V), staged in shared memory and stored by TMA
//     in whole lines (4-byte stores straight from the accumulators cost a
//     fifth of the product at V=256206 on an H100).
//  2. part[s] (+)= dz @ W[:, chunk]^T (tlp_mm<kDh>, dz by TMA), M = R, N =
//     d, K = the chunk, K split into S pieces so that a few hundred rows
//     still fill the card; piece s adds into its own fp32 partial [R, d],
//     whose tile belongs to one block per launch. A grid of more than one
//     wave walks d tiles fastest, so that the blocks that read one row tile
//     of dz run together. Chunks run in order on the stream.
// A last launch sums the S partials in order and casts to bf16.
//
// Backward, fp32 (the FMA path): row blocks of 32, a [32, <=1024] fp32 dh
// accumulator in shared memory; per 64-column vocab tile the block
// recomputes the logits, forms dz and adds dz @ W_tile^T into the
// accumulator; each vocab slice writes a partial dh and a reduce launch sums
// the slices in order.
#include <cuda.h>                 // CUtensorMap; its encoder is fetched at run time
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
// bf16: the warp-specialised wgmma mainloop of every product
// ---------------------------------------------------------------------------

constexpr int TM = 128, TN = 128, TK = 64;   // block tile and K-step of every product
constexpr int kStages = 6;                   // depth of the shared-memory ring
constexpr int kMmThreads = 384;              // warpgroups 0-1 consume, 2 produces
constexpr int kTileBytes = TM * TK * 2;      // one operand's K-step: 128 rows of 128 bytes
constexpr int kStageBytes = 2 * kTileBytes;  // A's tile, then B's
constexpr int kOutBytes = TM * 64 * 2;       // a consumer's dz staging: 128 rows x 64 columns
constexpr int MM_SMEM = kStages * kStageBytes + 2 * kOutBytes + (2 * kStages + 2) * 8 + 1024;
                                             // + dz staging (or kFwd's statistics' hand-over),
                                             // barriers, alignment

// An operand of a tiled product: element (i, k) is p[(i0 + i) * si + (k0 + k)
// * sk], zero where i0 + i >= rows or k0 + k >= K. tma: its tiles come by TMA
// through the launch's tensor map of the same tensor (coordinates i0 + i, k0
// + k), else by the producer's copies of `width` bytes (copy_unit; set by
// the launcher).
struct Opnd {
  const bf16* p;
  long long si, sk;
  int rows, K, i0, k0, tma, width;
};

enum { kFwd, kDz, kDh };          // the epilogues

struct MmArgs {
  Opnd A, B;                      // A's k is contiguous; B is (n, k)
  int R;                          // output rows (A's rows)
  int n_tiles, slice_tiles;       // kFwd, kDz: B's 128-row tiles, walked slice_tiles
                                  // a block (grid y: the slice)
  int k_end, piece;               // K walked: [0, k_end); kDh: [z * piece, +piece)
  unsigned full_count;            // arrivals that fill a stage
  const int* tgt;                 // kFwd, kDz
  const float *lse, *ent, *g_lp, *g_ent;   // kDz
  float4* part4;                  // kFwd: [slices, R] statistics (kDz writes the dz chunk
                                  // through the launch's third tensor map)
  float* part;                    // kDh: [splits, R, dout] fp32 partials
  int dout, add;
  int dfast;                      // kDh: the grid's x walks d tiles, y row tiles
  int V;                          // kFwd, kDz: columns at or past V enter nothing
  float cap;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, unsigned src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void st_shared_u32(unsigned addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// The 128 threads of consumer warpgroup wg (named barriers 2 and 3).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// cp.async of N bytes (16, 8 or 4), the first `bytes` of them read and the
// rest zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int bytes) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(N), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte unit of a staged tile: the 8 elements src[q * step], the first
// n of them in range (0 <= n <= 8), the rest zero. width (16, 8 or 4; step
// 1): cp.async copies of that many bytes, the source size zero-filling the
// rest; 2: element loads and a shared-memory store.
__device__ __forceinline__ void copy_unit(unsigned dst, const bf16* src, long long step, int n,
                                          int width) {
  const int b = 2 * n;
  if (n > 0 && width == 16) {
    cp_async<16>(dst, src, b);
  } else if (n > 0 && width == 8) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      cp_async<8>(dst + 8 * q, b > 8 * q ? src + 4 * q : src, min(8, max(0, b - 8 * q)));
  } else if (n > 0 && width == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async<4>(dst + 4 * q, b > 4 * q ? src + 2 * q : src, min(4, max(0, b - 4 * q)));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned lo = 2 * q < n ? s[2 * q * step] : 0u;
      const unsigned hi = 2 * q + 1 < n ? s[(2 * q + 1) * step] : 0u;
      v[q] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]),
                 "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// A producer warp's copies of one operand's K-step (rows [i, i + 128), k [k,
// k + 64)) into a stage; lane: 0..31, 32 units each. MN
// false: the tile is [128 i][64 k], k contiguous; true: two [64 k][64 i]
// halves (i in [0, 64), then [64, 128)), i contiguous. Either way rows of 128
// bytes whose 16-byte units are permuted by XOR with the row's low 3 bits:
// the layout TMA's 128-byte swizzle writes. Neighbouring threads take
// neighbouring units of a row; every copy of the launch has one width
// (o.width), so that rows of different alignment do not split a warp.
template <bool MN>
__device__ __forceinline__ void fill(unsigned dst, const Opnd& o, int i, int k, int lane) {
#pragma unroll 2
  for (int u = lane; u < TM * TK / 8; u += 32) {
    const int c = u & 7;
    if (!MN) {
      const int r = u >> 3;
      const long long ig = (long long)o.i0 + i + r, kg = (long long)o.k0 + k + 8 * c;
      const int n = ig < o.rows ? (int)max(0LL, min(8LL, o.K - kg)) : 0;
      copy_unit(dst + r * 128 + ((c ^ (r & 7)) << 4), o.p + ig * o.si + kg * o.sk, o.sk, n,
                o.width);
    } else {
      const int h = u >> 9, r = (u >> 3) & 63;
      const long long ig = (long long)o.i0 + i + 64 * h + 8 * c, kg = (long long)o.k0 + k + r;
      const int n = kg < o.K ? (int)max(0LL, min(8LL, o.rows - ig)) : 0;
      copy_unit(dst + h * (kTileBytes / 2) + r * 128 + ((c ^ (r & 7)) << 4),
                o.p + ig * o.si + kg * o.sk, o.si, n, o.width);
    }
  }
}

// wgmma's descriptor of a tile in shared memory with the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), mode 1.
// K-major: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// offset; the leading one unused). MN-major: 64-element runs of the n index,
// 8-k groups 1024 bytes apart (stride), the next 64 n 8192 bytes on
// (leading).
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products (they are written by the tensor cores until a wait).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]^T for the warpgroup, bf16 in, fp32
// accumulate, both from shared memory; B_MN: B's tile is n-contiguous (the
// transpose bit). Thread t's d[4j + 2i + c] is row 16 (t / 32) + (t % 32) / 4
// + 8i, column 8j + 2 (t % 4) + c.
template <bool B_MN>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(B_MN ? 1 : 0));
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {       // 2^x, approximate (MUFU)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (max, l, s) of the thread's 32 columns of row i of the accumulators, l and
// s against that max; MASK: the columns at or past `past` are left out.
template <bool MASK>
__device__ __forceinline__ float4 lane_stats(const float (&acc)[64], int i, int past) {
  float mx = kNegInf;
#pragma unroll
  for (int e = 0; e < 16; ++e)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (!MASK || 8 * e + c < past) mx = fmaxf(mx, acc[4 * e + 2 * i + c]);
  const float sh = mx * kLog2e;
  float l = 0.f, sz = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (!MASK || 8 * e + c < past) {
        const float z = acc[4 * e + 2 * i + c];
        const float p = ex2(fmaf(z, kLog2e, -sh));
        l += p;
        sz = fmaf(p, z, sz);
      }
  return make_float4(mx, l, sz, kNegInf);
}

// dz (see the note at the top) of the thread's 16 columns v0 + 8e + c (e in
// [e0, e0 + 8), c < 2) of row i of the accumulators, each pair rounded to
// bf16 and handed to sink(e, pair). CAP: the logits pass a softcap; MASK:
// columns at or past V (zero-filled) get 0.
template <bool CAP, bool MASK, typename Sink>
__device__ __forceinline__ void dz_row(const float (&acc)[64], int i, int e0, int v0, int V,
                                       int t, float lse, float ent, float g_lp, float g_ent,
                                       float cap, Sink sink) {
  const float sl = lse * kLog2e, c1 = ent - lse;
#pragma unroll
  for (int e = e0; e < e0 + 8; ++e) {
    float o[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int v = v0 + 8 * e + c;
      float z = acc[4 * e + 2 * i + c], scale = 1.f;
      if (CAP) {
        const float th = tanhf(z / cap);
        z = th * cap;
        scale = 1.f - th * th;
      }
      // g_lp (1[v = t] - p) - g_ent p (z - lse + ent)
      float dz = ex2(fmaf(z, kLog2e, -sl)) * fmaf(-g_ent, z + c1, -g_lp);
      if (v == t) dz += g_lp;
      o[c] = !MASK || v < V ? dz * scale : 0.f;
    }
    const __nv_bfloat162 pair = __floats2bfloat162_rn(o[0], o[1]);
    sink(e, *reinterpret_cast<const unsigned*>(&pair));
  }
}

// The products of one tile: K-steps it0 .. it0 + nk - 1 of the ring into
// acc, H halves of 64 rows whose A rows start at byte a_off of a stage's A
// tile, each K-step issued as soon as its stage is full; a stage goes back to
// the producer (lane 0 of each warp arrives on its empty barrier) once the
// products reading it are done. `issued`, if set, is arrived on once the last
// products are issued.
template <int H, bool B_MN>
__device__ __forceinline__ void mma_tile(float (&acc)[H][64], uint64_t* full, uint64_t* empty,
                                         unsigned base, int it0, int nk, unsigned a_off,
                                         int lane, uint64_t* issued) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[h][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int it = it0 + kt, s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned sa = base + s * kStageBytes + a_off;
    const unsigned sb = base + s * kStageBytes + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_acc(acc[h]);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t db = B_MN ? gmma_desc(sb + 2048 * kk, kTileBytes / 2, 1024)
                               : gmma_desc(sb + 32 * kk, 16, 1024);
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma<B_MN>(acc[h], gmma_desc(sa + h * (kTileBytes / 2) + 32 * kk, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();              // the previous K-step's products are done
#pragma unroll
    for (int h = 0; h < H; ++h) fence_acc(acc[h]);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  if (issued && lane == 0) mbar_arrive(issued);
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < H; ++h) fence_acc(acc[h]);
  if (nk > 0 && lane == 0) mbar_arrive(&empty[(it0 + nk - 1) % kStages]);
}

// kFwd's and kDz's consumers (see tlp_mm): rows m0 + 64 h + rl + 8 i of every
// tile, q = 2 h + i.
template <int EPI, bool B_MN>
__device__ __forceinline__ void consume_pingpong(const MmArgs& a, const CUtensorMap* map_dz,
                                                 uint64_t* full, uint64_t* empty,
                                                 uint64_t* turn, unsigned char* out,
                                                 unsigned base, int m0, int first, int count,
                                                 int nk) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int q2 = 2 * (lane & 3);
  const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  int tg[4];
  float L[4], En[4], gl[4], ge[4];
  float4 run[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = m0 + 64 * (q >> 1) + rl + 8 * (q & 1);
    const bool ok = r < a.R;
    run[q] = make_float4(kNegInf, 0.f, 0.f, kNegInf);
    tg[q] = ok ? a.tgt[r] : -1;
    if (EPI == kDz) {
      L[q] = ok ? a.lse[r] : 0.f;
      En[q] = ok ? a.ent[r] : 0.f;
      gl[q] = ok ? a.g_lp[r] : 0.f;
      ge[q] = ok ? a.g_ent[r] : 0.f;
    }
  }
  float acc[2][64];
  for (int t = wg, j = 0; t < count; t += 2, ++j) {
    if (t > 0) mbar_wait(&turn[wg], (j - (wg == 0)) & 1);   // the other's products issued
    mma_tile<2, B_MN>(acc, full, empty, base, t * nk, nk, 0, lane, &turn[wg ^ 1]);
    const int n = (first + t) * TN;
    if (EPI == kFwd) {
      if (a.cap != 0.f) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[h][e] = tanhf(acc[h][e] / a.cap) * a.cap;
      }
      // the thread's columns of each of its rows: c0 + 8e + c. Each lane
      // keeps its own running statistics over its columns (the quad's are
      // merged once, at the end); only a vocabulary's last tile has columns
      // at or past V (zero-filled), which enter no statistic
      const int c0 = a.B.i0 + n + q2, past = a.V - c0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 st = past > 8 * 15 + 1 ? lane_stats<false>(acc[q >> 1], q & 1, past)
                                            : lane_stats<true>(acc[q >> 1], q & 1, past);
        float tv = kNegInf;
        const int tcol = tg[q] - c0;
        if ((unsigned)tcol < 8u * 16) {          // the target may be one of these
#pragma unroll
          for (int e = 0; e < 16; ++e)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (8 * e + c == tcol) tv = acc[q >> 1][4 * e + 2 * (q & 1) + c];
        }
        run[q] = merge_stats(run[q], make_float4(st.x, st.y, st.z, tv));
      }
    } else {
      // dz goes out through shared memory, 64 columns at a time (the tile's
      // 128 rows; TMA clips rows past R): the 128-byte swizzle keeps the
      // quads' 4-byte writes clear of bank conflicts, and TMA writes whole
      // lines where 4-byte stores from registers would not
      const unsigned stg = smem_u32(out) + wg * kOutBytes;
      const int v0 = a.B.i0 + n + q2;
      const bool mask = a.V - v0 <= 8 * 15 + 1;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 64 * (q >> 1) + rl + 8 * (q & 1);
          auto sink = [&](int e, unsigned pair) {
            st_shared_u32(stg + row * 128 + (((e & 7) ^ (row & 7)) << 4) + 2 * q2, pair);
          };
          if (a.cap != 0.f)
            dz_row<true, true>(acc[q >> 1], q & 1, 8 * b, v0, a.V, tg[q], L[q], En[q], gl[q],
                               ge[q], a.cap, sink);
          else if (mask)
            dz_row<false, true>(acc[q >> 1], q & 1, 8 * b, v0, a.V, tg[q], L[q], En[q], gl[q],
                                ge[q], a.cap, sink);
          else
            dz_row<false, false>(acc[q >> 1], q & 1, 8 * b, v0, a.V, tg[q], L[q], En[q],
                                 gl[q], ge[q], a.cap, sink);
        }
        fence_proxy_async();      // the writes, to TMA
        wg_sync(wg);
        if ((threadIdx.x & 127) == 0) {
          tma_store(map_dz, stg, n + 64 * b, m0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        wg_sync(wg);              // the staging is free again
      }
    }
  }
  if (EPI == kDz && (threadIdx.x & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (EPI == kFwd) {
    float4* red = reinterpret_cast<float4*>(out);   // [TM]
    // each row's statistics are split over the quad's lanes (shuffles, in a
    // fixed order) and the two warpgroups' tiles: the second hands its share
    // to the first through shared memory
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        run[q] = merge_stats(run[q], make_float4(__shfl_xor_sync(0xffffffffu, run[q].x, off),
                                                 __shfl_xor_sync(0xffffffffu, run[q].y, off),
                                                 __shfl_xor_sync(0xffffffffu, run[q].z, off),
                                                 __shfl_xor_sync(0xffffffffu, run[q].w, off)));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 64 * (q >> 1) + rl + 8 * (q & 1);
      if (wg == 1 && (lane & 3) == 0) red[row] = run[q];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 64 * (q >> 1) + rl + 8 * (q & 1);
        if (m0 + row < a.R)
          a.part4[(size_t)blockIdx.y * a.R + m0 + row] = merge_stats(run[q], red[row]);
      }
    }
  }
}

// One block: rows [m0, m0 + 128) of A against B's 128-row tiles. kFwd, kDz:
// tiles [y * slice_tiles, +slice_tiles) of n_tiles, each over K [0, k_end);
// kDh: the tile y over K [z * piece, min(k_end, (z + 1) * piece)). B_MN: B's
// tiles are n-contiguous. Epilogues: kFwd folds each tile into its rows'
// statistics and writes part4[y * R + row]; kDz writes dz[row, tile column]
// (B.i0: the chunk's first vocab column); kDh writes (or, add, adds to)
// part[z][row][column].
//
// kDh's two consumer warpgroups share each tile, 64 rows each. kFwd and kDz
// run them in ping-pong: warpgroup g takes the block's tiles g, g + 2, ...,
// all 128 rows of each, and the two take turns at the tensor cores (`turn`
// barriers), so that one's epilogue runs while the other's products do. The
// turns also keep a warpgroup from waiting on a stage before the stage's
// previous K-step, the other's, has been waited for.
template <int EPI, bool B_MN>
__global__ void __launch_bounds__(kMmThreads, 1)
tlp_mm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
       const __grid_constant__ CUtensorMap map_dz, const __grid_constant__ MmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023) & ~1023u;      // the swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  unsigned char* out = smem + kStages * kStageBytes;   // 2 x kOutBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], a.full_count);
      mbar_init(&empty[s], EPI == kDh ? 8 : 4);   // lane 0 of each warp that reads it
    }
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  const int m0 = (EPI == kDh && a.dfast ? blockIdx.y : blockIdx.x) * TM;
  int first, count, kb, ke;
  if (EPI == kDh) {
    first = a.dfast ? blockIdx.x : blockIdx.y;
    count = 1;
    kb = blockIdx.z * a.piece;
    ke = min(a.k_end, kb + a.piece);
  } else {
    first = blockIdx.y * a.slice_tiles;
    count = min(a.n_tiles - first, a.slice_tiles);
    kb = 0;
    ke = a.k_end;
  }
  const int nk = ke > kb ? (ke - kb + TK - 1) / TK : 0;

  if (threadIdx.x >= 256) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const bool copies = !a.A.tma || !a.B.tma;
    const int pt = threadIdx.x - 256, pw = pt >> 5, lane = pt & 31;
    // TMA alone: the first thread issues every stage's loads. Copies: warp pw
    // fills the stages it % 4 == pw, its lanes' copies awaited, fenced to the
    // async proxy and announced before it takes its next stage, so that four
    // stages' copies are in flight at once.
    if (!copies && pt != 0) return;
    const unsigned tx = (a.A.tma ? kTileBytes : 0) + (a.B.tma ? kTileBytes : 0);
    int it = 0;
    for (int t = 0; t < count; ++t) {
      const int n = (first + t) * TN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        if (copies && it % 4 != pw) continue;
        const int s = it % kStages, k = kb + kt * TK;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* sa = smem + s * kStageBytes;
        unsigned char* sb = sa + kTileBytes;
        if (lane == 0) {
          mbar_arrive_tx(&full[s], tx);
          if (a.A.tma) tma_load(sa, &map_a, a.A.k0 + k, a.A.i0 + m0, &full[s]);
          if (a.B.tma) {
            if (B_MN) {
              tma_load(sb, &map_b, a.B.i0 + n, a.B.k0 + k, &full[s]);
              tma_load(sb + kTileBytes / 2, &map_b, a.B.i0 + n + 64, a.B.k0 + k, &full[s]);
            } else {
              tma_load(sb, &map_b, a.B.k0 + k, a.B.i0 + n, &full[s]);
            }
          }
        }
        if (copies) {
          if (!a.A.tma) fill<false>(smem_u32(sa), a.A, m0, k, lane);
          if (!a.B.tma) fill<B_MN>(smem_u32(sb), a.B, n, k, lane);
          cp_async_commit();
          cp_async_wait<0>();
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  if constexpr (EPI == kDh) {
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int q2 = 2 * (lane & 3);  // the thread's first column in each 8-column block
    const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);   // its rows: rl + 8 i
    float acc[1][64];
    mma_tile<1, B_MN>(acc, full, empty, base, 0, nk, wg * (kTileBytes / 2), lane, nullptr);
    float* out = a.part + (size_t)blockIdx.z * a.R * a.dout;
    const int n = first * TN;
    const bool pairs = (a.dout & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + 64 * wg + rl + 8 * i;
      if (r >= a.R) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = n + q2 + 8 * j;
        float* o = out + (size_t)r * a.dout + c;
        const float x0 = acc[0][4 * j + 2 * i], x1 = acc[0][4 * j + 2 * i + 1];
        if (pairs && c + 1 < a.dout) {
          float2 v = make_float2(x0, x1);
          if (a.add) {
            const float2 w = *reinterpret_cast<const float2*>(o);
            v.x += w.x;
            v.y += w.y;
          }
          *reinterpret_cast<float2*>(o) = v;
        } else {
          if (c < a.dout) o[0] = a.add ? o[0] + x0 : x0;
          if (c + 1 < a.dout) o[1] = a.add ? o[1] + x1 : x1;
        }
      }
    }
  } else {
    consume_pingpong<EPI, B_MN>(a, &map_dz, full, empty, turn, out, base, m0, first, count,
                                nk);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {                  // of the current device, read once
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

void vec_flags(const void* h, const void* w, int d, long long ws_k, long long ws_v, int* vec_h,
               int* vec_w) {
  *vec_h = aligned16(h) && d % VEC == 0;
  *vec_w = ws_k == 1 && aligned16(w) && ws_v % VEC == 0 && d % VEC == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map: `inner` elements contiguous, `outer` rows `stride`
// elements apart; boxes of 64 x box_outer elements (128-byte rows) with the
// 128-byte swizzle, zeros outside the extents.
bool make_map(CUtensorMap* m, const void* p, long long inner, long long outer, long long stride,
              int box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Whether W [d, V] (element (k, v) at w[k * ws_k + v * ws_v]) can come by
// TMA: one stride 1, the other a multiple of 16 bytes and no shorter than the
// contiguous extent, the base 16-byte aligned (token_logprob.py's w_feed).
bool w_tma_ok(const bf16* w, int d, int V, long long ws_k, long long ws_v) {
  if (!aligned16(w)) return false;
  if (ws_k == 1) return ws_v % 8 == 0 && ws_v >= d;
  if (ws_v == 1) return ws_k % 8 == 0 && ws_k >= V;
  return false;
}

// W's tensor map for a product whose B tile is MN-major (boxes of 64 x 64:
// two a tile) or K-major (64 x 128).
bool w_map(CUtensorMap* m, const bf16* w, int d, int V, long long ws_k, long long ws_v,
           bool b_mn) {
  return ws_k == 1 ? make_map(m, w, d, V, ws_v, b_mn ? 64 : 128)
                   : make_map(m, w, V, d, ws_k, b_mn ? 64 : 128);
}

// The bytes every copy of an operand moves when the producer copies it (see
// copy_unit): the widest power of two up to 16 dividing its base and its
// row stride in bytes along a unit-stride dimension, else 2 (element loads).
int copy_width(const bf16* p, long long s_other, long long s_contig) {
  if (s_contig != 1) return 2;
  const uintptr_t x = reinterpret_cast<uintptr_t>(p) | (uintptr_t)(2 * s_other);
  return (x & 15) == 0 ? 16 : (x & 7) == 0 ? 8 : (x & 3) == 0 ? 4 : 2;
}

// Whether W's tiles come 16 bytes at a time: by TMA, or by 16-byte copies.
int w_wide(const bf16* w, long long ws_k, long long ws_v, int w_tma) {
  return w_tma || (ws_k == 1 ? copy_width(w, ws_v, 1) : copy_width(w, ws_k, ws_v)) == 16;
}

template <int EPI, bool B_MN>
cudaError_t launch_mm(dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb,
                      const CUtensorMap& mdz, MmArgs a, cudaStream_t st) {
  static bool attr_set = false;   // a repeated first call sets the same value
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tlp_mm<EPI, B_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  a.full_count = 1 + (a.A.tma && a.B.tma ? 0 : 32);   // + a copying warp's lanes
  a.A.width = copy_width(a.A.p, a.A.si, a.A.sk);      // A's k is contiguous
  a.B.width = B_MN ? copy_width(a.B.p, a.B.sk, a.B.si) : copy_width(a.B.p, a.B.si, a.B.sk);
  tlp_mm<EPI, B_MN><<<grid, kMmThreads, MM_SMEM, st>>>(ma, mb, mdz, a);
  return cudaGetLastError();
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
                     int vsplit, int slice_tiles, float cap, int w_tma, cudaStream_t st,
                     int* launched, int* w_vector) {
  if (w_tma && !w_tma_ok(w, d, V, ws_k, ws_v)) return cudaErrorInvalidValue;
  // B(n = v, k = j) = W[j, v]: n-contiguous tiles where W's v stride is the
  // smaller (an untied [d, V] head)
  const bool b_mn = ws_v < ws_k;
  MmArgs a{};
  a.A = Opnd{h, d, 1, R, d, 0, 0, aligned16(h) && d % 8 == 0};
  a.B = Opnd{w, ws_v, ws_k, V, d, 0, 0, w_tma};
  CUtensorMap ma{}, mb{};
  if ((a.A.tma && !make_map(&ma, h, d, R, d, TM)) ||
      (w_tma && !w_map(&mb, w, d, V, ws_k, ws_v, b_mn)))
    return cudaErrorInvalidValue;
  a.R = R;
  a.n_tiles = (V + TN - 1) / TN;
  a.slice_tiles = slice_tiles;
  a.k_end = d;
  a.tgt = tgt;
  a.part4 = part;
  a.V = V;
  a.cap = cap;
  const dim3 grid((R + TM - 1) / TM, vsplit);
  const CUtensorMap none{};
  const cudaError_t err = b_mn ? launch_mm<kFwd, true>(grid, ma, mb, none, a, st)
                               : launch_mm<kFwd, false>(grid, ma, mb, none, a, st);
  if (err != cudaSuccess) return err;
  ++*launched;
  *w_vector += w_wide(w, ws_k, ws_v, w_tma);
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
                     int vc, int splits, int piece, int p1_tiles, float cap, int w_tma,
                     cudaStream_t st, int* launched, int* w_vector) {
  // dz goes out and back by TMA: the wrapper's scratch is aligned
  if ((w_tma && !w_tma_ok(w, d, V, ws_k, ws_v)) || !aligned16(dz)) return cudaErrorInvalidValue;
  // the tied embedding's transpose (k contiguous): product 1's B tiles are
  // K-major, product 2's n-contiguous; an untied head the other way round
  const bool k_contig = ws_k == 1;
  MmArgs p1{}, p2{};
  p1.A = Opnd{h, d, 1, R, d, 0, 0, aligned16(h) && d % 8 == 0};
  p2.A = Opnd{dz, vc, 1, R, vc, 0, 0, 1};
  CUtensorMap mh{}, mdz{}, mw1{}, mw2{};
  if ((p1.A.tma && !make_map(&mh, h, d, R, d, TM)) || !make_map(&mdz, dz, vc, R, vc, TM) ||
      (w_tma && !(w_map(&mw1, w, d, V, ws_k, ws_v, !k_contig) &&
                  w_map(&mw2, w, d, V, ws_k, ws_v, k_contig))))
    return cudaErrorInvalidValue;
  p1.R = p2.R = R;
  p1.slice_tiles = p1_tiles;
  p1.k_end = d;
  p1.tgt = tgt;
  p1.lse = lse;
  p1.ent = ent;
  p1.g_lp = g_lp;
  p1.g_ent = g_ent;
  p1.V = V;
  p1.cap = cap;
  p2.piece = piece;
  p2.part = part;
  p2.dout = d;
  const int row_tiles = (R + TM - 1) / TM, d_tiles = (d + TN - 1) / TN;
  // product 2 in more than one wave: d tiles fastest, so that the blocks
  // reading one row tile of dz run together and dz comes from memory once
  p2.dfast = (long long)row_tiles * d_tiles * splits > sm_count();
  for (int v0 = 0; v0 < V; v0 += vc) {
    const int kc = min(vc, V - v0);                  // the chunk's vocab columns
    const int kpad = (kc + TN - 1) / TN * TN;        // ... as whole tiles
    // product 1: B(n = v, k = j) = W[j, v0 + v]
    p1.B = Opnd{w, ws_v, ws_k, V, d, v0, 0, w_tma};
    p1.n_tiles = kpad / TN;
    const dim3 g1(row_tiles, (p1.n_tiles + p1_tiles - 1) / p1_tiles);
    cudaError_t err = k_contig ? launch_mm<kDz, false>(g1, mh, mw1, mdz, p1, st)
                               : launch_mm<kDz, true>(g1, mh, mw1, mdz, p1, st);
    if (err != cudaSuccess) return err;
    ++*launched;
    // product 2: A = dz [R, kpad]; B(n = j, k = v) = W[j, v0 + v]
    p2.B = Opnd{w, ws_k, ws_v, d, V, 0, v0, w_tma};
    p2.k_end = kpad;
    p2.add = v0 > 0;
    const dim3 g2 = p2.dfast ? dim3(d_tiles, row_tiles, splits) : dim3(row_tiles, d_tiles, splits);
    err = k_contig ? launch_mm<kDh, true>(g2, mdz, mw2, mdz, p2, st)
                   : launch_mm<kDh, false>(g2, mdz, mw2, mdz, p2, st);
    if (err != cudaSuccess) return err;
    ++*launched;
    *w_vector += w_wide(w, ws_k, ws_v, w_tma);
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
// 128 (bfloat16). w_tma (bfloat16): W's tiles come by TMA (the launcher
// refuses it where W's base or strides do not allow it), else by the
// producer's copies. Each launcher adds one to *launched (a host int) for
// every kernel it launches, and one to *w_vector (a host int) for every vocab
// chunk whose W it loads by TMA or 16-byte copies (the forward and the fp32
// backward have one chunk).
extern "C" int token_logprob_fwd_launch(const void* h, const void* w, const void* tgt,
                                        void* part, void* lp, void* ent, void* lse, int R,
                                        int d, int V, long long ws_k, long long ws_v,
                                        int vsplit, int slice_tiles, float cap, int dtype,
                                        int w_tma, void* stream, int* launched, int* w_vector) {
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
                       R, d, V, ws_k, ws_v, vsplit, slice_tiles, cap, w_tma, st, launched,
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
// columns (a multiple of 128); dz: [R, vc] bf16 scratch; product 1 walks a
// chunk's 128-column tiles p1_tiles a block; the dz @ W^T product of a chunk
// splits its K into `splits` pieces of `piece` columns (a multiple of 64,
// splits * piece >= vc); part: [splits, R, d] float32 scratch; dh: [R, d]
// bf16. Other arguments as in the forward and the fp32 backward.
extern "C" int token_logprob_bwd_bf16_launch(const void* h, const void* w, const void* tgt,
                                             const void* lse, const void* ent, const void* g_lp,
                                             const void* g_ent, void* dz, void* part, void* dh,
                                             int R, int d, int V, long long ws_k,
                                             long long ws_v, int vc, int splits, int piece,
                                             int p1_tiles, float cap, int w_tma, void* stream,
                                             int* launched, int* w_vector) {
  if (R < 0 || d <= 0 || V <= 0 || vc <= 0 || vc % TN || splits < 1 || splits > 65535 ||
      piece <= 0 || piece % TK || (long long)splits * piece < vc || p1_tiles < 1 ||
      (ws_k != 1 && ws_v != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  return (int)bwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                       static_cast<const int*>(tgt), static_cast<const float*>(lse),
                       static_cast<const float*>(ent), static_cast<const float*>(g_lp),
                       static_cast<const float*>(g_ent), static_cast<bf16*>(dz),
                       static_cast<float*>(part), static_cast<bf16*>(dh), R, d, V, ws_k, ws_v,
                       vc, splits, piece, p1_tiles, cap, w_tma,
                       static_cast<cudaStream_t>(stream), launched, w_vector);
}
