// decode_common.cuh: the single-token GQA attention body that gqa_decode.cu
// (contiguous cache) and paged_decode.cu (page pool through a block table)
// share. The two kernels differ only in where logical key idx of a row lives;
// each passes `rows`, a functor giving the element offset of key idx's K/V
// row (kv head 0).
//
// What bounds it on an H100: device-memory bytes. Each valid K and V row is
// read once and does 4*hd flops per query head, far below the ~295
// flops/byte at which the tensor cores become the limit. So the design is
// about keeping enough bytes in flight on every SM:
// - Split over keys. The grid is (split, kv head g, row b); block s takes
//   the s-th chunk of the row's live keys [lo, hi), counted from lo rounded
//   down to a whole page (span below), and a block past the row's last
//   chunk exits at once. The host's plan (decode_plan) picks the chunk from
//   static shapes only, so that B x KVH x live splits fills the card
//   several blocks an SM; with a window the grid holds only the chunks a
//   window can touch, and a window no longer than a chunk takes one block.
//   A block has 4 warps; 8 where the plan has few blocks (short caches:
//   with one or two live blocks an SM, its keys go faster with more warps).
// - 16-byte loads, several keys in flight. LPR lanes hold one K/V row, each
//   lane NV 16-byte vectors of it, so one warp load covers KPW = 32/LPR keys
//   (bf16 hd=128: 16 lanes a row, 2 keys a load, the dot reduced by 4
//   shuffles). Each group of LPR lanes is a "virtual warp" with its own fp32
//   online softmax (running max m, sum l, accumulator acc) in registers, and
//   loads U keys straight into registers before it uses any. The rep query
//   heads of the group use each loaded row once. Scores are kept in log2
//   units (q is pre-scaled by log2(e)/sqrt(hd)), so each key costs one exp2.
//   Measured on an H100 against this: two register buffers (one loading
//   while the other is folded), a cp.async ring of 3 to 8 stages in shared
//   memory, U = 8, 8 blocks an SM forced by __launch_bounds__, and the split
//   as the grid's slowest dimension; none was faster beyond run-to-run
//   spread, most were slower (more registers, fewer blocks an SM). With rows
//   of random length the longest rows' last chunks set the time.
// - An in-order merge, no float atomics. The virtual warps of a warp merge
//   by shuffles, the warps through shared memory in warp order. A row whose
//   live keys lie in one chunk writes its output directly. Otherwise each
//   live split writes (m, l, acc[hd]) for its rep heads into fp32 scratch;
//   the block that takes the last integer ticket of its (row, kv head) folds
//   the splits in split order and resets the ticket to 0 (so a CUDA-graph
//   replay starts from 0 again). The output's bits do not depend on which
//   block finishes last.
// m starts at kNegInf = -1e30, not -inf: a virtual warp or row with no key
// then merges as exp2(-1e30 - M) * 0 = 0, where -inf - -inf would give NaN.
// The output is acc / max(l, 1e-30) in T (0 for a row with no key).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode {

// Warps a block may have: 4, or 8 where their fold (sm_acc) fits 32 KB of
// static shared memory.
constexpr bool warps_fit(int warps, int rep, int hd) {
  return warps == 4 || (warps == 8 && rep * hd <= 1024);
}
constexpr int kMaxChunkPages = 256;   // table entries a paged block stages
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// 16 bytes as floats: 4 fp32, or 8 bf16 (a bf16 is the top half of an fp32).
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// How a K/V row of HD elements of T spreads over a warp, and a block of
// WARPS warps.
template <typename T, int HD, int WARPS>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);                   // elements a 16-byte load
  static constexpr int LPR = HD / VEC < 32 ? HD / VEC : 32;    // lanes a row
  static constexpr int NV = HD / (LPR * VEC);                  // loads a lane a row
  static constexpr int EPL = NV * VEC;                         // elements a lane
  static constexpr int KPW = 32 / LPR;                         // keys a warp load
  static constexpr int NVW = WARPS * KPW;                      // virtual warps a block
};

// Where this block's work lies: the number of chunks the row's live keys
// [lo, hi) touch (n_live) and the block's own keys [k0, k1). Chunks are
// counted from base = lo rounded down to a multiple of `align` (the page for
// the pool, 1 for the contiguous cache), so block s takes keys
// [base + s*chunk, base + (s+1)*chunk) of [lo, hi).
struct Span {
  int n_live, k0, k1;
  bool dead;
};

__device__ __forceinline__ Span span(int p, int capacity, int window, int chunk, int align,
                                     int s) {
  const int hi = min(p, capacity);
  const int lo = window > 0 ? max(0, p - window) : 0;
  const int base = lo / align * align;
  Span sp;
  sp.n_live = hi > lo ? (hi - base + chunk - 1) / chunk : 1;   // no key: block 0 writes 0
  sp.dead = s >= sp.n_live;
  sp.k0 = max(lo, base + s * chunk);
  sp.k1 = min(hi, base + (s + 1) * chunk);
  return sp;
}

// The splits a launch needs: every chunk of the capacity, or with a window
// at most cdiv(window + align - 1, chunk) chunks a row.
inline int splits_needed(int capacity, int window, int chunk, int align) {
  const int all = (capacity + chunk - 1) / chunk;
  const int win = (window + align - 1 + chunk - 1) / chunk;
  return window > 0 && win < all ? win : all;
}

// q: [B, KVH*REP, HD]; ck/cv: the cache (rows(idx) + g*HD is key idx's head-g
// row); out: like q; part: [B, KVH, splits, REP, HD+2] fp32 (acc, then m and
// l); tickets: [B*KVH] int, 0 between launches. qscale multiplies q so that
// q.k is the score in log2 units (no softcap) or score/softcap (softcap);
// capmul = softcap*log2(e), 0 for none.
template <typename T, int HD, int REP, int WARPS, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ ck,
                                       const T* __restrict__ cv, T* __restrict__ out,
                                       float* __restrict__ part, int* __restrict__ tickets,
                                       int KVH, int splits, const Span& sp, const Rows& rows,
                                       float qscale, float capmul) {
  using L = Layout<T, HD, WARPS>;
  constexpr int kThreads = WARPS * 32;
  constexpr int EPL = L::EPL, NV = L::NV, VEC = L::VEC, LPR = L::LPR;
  // keys a virtual warp loads at once: 8 where a warp load holds one key row
  // (fp32 hd 128, bf16 hd 256) and q and acc leave registers for them, so
  // that a warp has 8 keys in flight as for bf16 hd 128; else 4, or 2
  // beside a large q and acc
  constexpr int U = L::KPW == 1 && NV == 1 && REP * EPL <= 16 ? 8 : REP * EPL <= 32 ? 4 : 2;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPR;                               // lane within its row
  const int vw = warp * L::KPW + lane / LPR;               // virtual warp in the block
  const int H = KVH * REP;

  // element e = v*VEC + j of this lane is element li*VEC + v*LPR*VEC + j of a row
  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const T* qr = q + ((size_t)b * H + g * REP + r) * HD + li * VEC;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unpack(__ldg(reinterpret_cast<const uint4*>(qr + v * LPR * VEC)), qf[r] + v * VEC, T());
#pragma unroll
      for (int j = 0; j < VEC; ++j) qf[r][v * VEC + j] *= qscale;
    }
  }

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const size_t off = (size_t)g * HD + li * VEC;
  const int nk = sp.k1 - sp.k0;
  for (int base = 0; base < nk; base += L::NVW * U) {
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * L::NVW + vw;
#pragma unroll
      for (int v = 0; v < NV; ++v) kr[u][v] = vr[u][v] = make_uint4(0, 0, 0, 0);
      if (j < nk) {
        const size_t at = rows(sp.k0 + j) + off;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kr[u][v] = __ldg(reinterpret_cast<const uint4*>(ck + at + v * LPR * VEC));
          vr[u][v] = __ldg(reinterpret_cast<const uint4*>(cv + at + v * LPR * VEC));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * L::NVW >= nk) break;                 // uniform over the block
      const bool live = base + u * L::NVW + vw < nk;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        unpack(kr[u][v], kf + v * VEC, T());
        unpack(vr[u][v], vf + v * VEC, T());
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) sc = fmaf(qf[r][e], kf[e], sc);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
        if (capmul > 0.f) sc = tanhf(sc) * capmul;
        if (live) {
          // one exp2: the smaller of the running max and the score scales
          const float d = sc - m[r];
          const float x = exp2f(-fabsf(d));
          const bool up = d > 0.f;
          const float alpha = up ? x : 1.f;
          const float pe = up ? 1.f : x;
          m[r] = up ? sc : m[r];
          l[r] = fmaf(l[r], alpha, pe);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(acc[r][e], alpha, pe * vf[e]);
        }
      }
    }
  }

  // the warp's virtual warps merge by shuffles (lanes of row-group 0 keep it)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float M = fmaxf(m[r], m2);
      const float f = exp2f(m[r] - M), f2 = exp2f(m2 - M);
      l[r] = l[r] * f + l2 * f2;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * f + a2 * f2;
      }
      m[r] = M;
    }
  }

  // then the warps, in warp order, through shared memory
  __shared__ float sm_m[WARPS][REP], sm_l[WARPS][REP];
  __shared__ float sm_acc[WARPS][REP][HD];
  __shared__ int sm_last;
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          sm_acc[warp][r][li * VEC + v * LPR * VEC + j] = acc[r][v * VEC + j];
    }
  }
  __syncthreads();

  const bool direct = sp.n_live == 1;
  float* pb = part + (((size_t)b * KVH + g) * splits) * REP * (HD + 2);
  for (int i = threadIdx.x; i < REP * HD; i += kThreads) {
    const int r = i / HD, e = i - r * HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sm_m[w][r] - M);
      Ls += sm_l[w][r] * f;
      A += sm_acc[w][r][e] * f;
    }
    if (direct) {
      from_f(A / fmaxf(Ls, 1e-30f), out + ((size_t)b * H + g * REP + r) * HD + e);
    } else {
      float* pr = pb + ((size_t)s * REP + r) * (HD + 2);
      pr[e] = A;
      if (e == 0) {
        pr[HD] = M;
        pr[HD + 1] = Ls;
      }
    }
  }
  if (direct) return;

  // the last live split of (b, g) to finish folds them all, in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(tickets + (size_t)b * KVH + g, 1);
    sm_last = t == sp.n_live - 1;
    if (sm_last) atomicExch(tickets + (size_t)b * KVH + g, 0);
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < REP * HD; i += kThreads) {
    const int r = i / HD, e = i - r * HD;
    float M = kNegInf;
    for (int t = 0; t < sp.n_live; ++t)
      M = fmaxf(M, __ldcg(pb + ((size_t)t * REP + r) * (HD + 2) + HD));
    float Ls = 0.f, A = 0.f;
    for (int t = 0; t < sp.n_live; ++t) {
      const float* pr = pb + ((size_t)t * REP + r) * (HD + 2);
      const float f = exp2f(__ldcg(pr + HD) - M);
      Ls += __ldcg(pr + HD + 1) * f;
      A += __ldcg(pr + e) * f;
    }
    from_f(A / fmaxf(Ls, 1e-30f), out + ((size_t)b * H + g * REP + r) * HD + e);
  }
}

}  // namespace decode
