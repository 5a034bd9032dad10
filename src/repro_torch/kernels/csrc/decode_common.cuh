// decode_common.cuh: the single-token GQA attention body that gqa_decode.cu
// (contiguous cache) and paged_decode.cu (page pool through a block table)
// share. The two kernels differ only in where logical key idx of a row lives;
// each passes `rows`, a functor giving the element offset of key idx's K/V
// row (kv head 0), and the key range [lo, hi) it wants attended.
//
// One block per (kv head g = blockIdx.x, row b = blockIdx.y) of kWarps warps;
// the rep query heads of the group share each K/V row the block reads. Each
// warp walks its own keys (warp w takes keys lo+w, lo+w+kWarps, ...), every
// lane holding EPL = ceil(HD/32) contiguous elements of a row (for HD = 16
// only lanes 0..15 hold any), kUnroll keys loaded before any is used, with
// its own fp32 online softmax (running max, sum, weighted accumulator) in
// registers. The warps' partial softmaxes merge through shared memory in
// warp order, so the result does not depend on scheduling; the output is
// acc / max(l, 1e-30) in T.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace decode {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// EPL contiguous elements of T, loaded as one aligned vector.
template <typename T, int EPL>
struct alignas(sizeof(T) * EPL) Pack {
  T v[EPL];
};

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  Pack<T, EPL> pk = *reinterpret_cast<const Pack<T, EPL>*>(p);
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_f(pk.v[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q: [B, KVH*REP, HD]; ck/cv: the cache (rows(idx) + g*HD is key idx's head-g
// row); out: like q. scale = 1/sqrt(HD); softcap 0 = none.
template <typename T, int HD, int REP, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ ck,
                                       const T* __restrict__ cv, T* __restrict__ out,
                                       int KVH, int lo, int hi, const Rows& rows,
                                       float scale, float softcap) {
  constexpr int EPL = (HD + 31) / 32;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = KVH * REP;
  const bool holds = lane * EPL < HD;

  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[r][e] = 0.f;
    if (holds)
      load_row<T, EPL>(q + ((size_t)b * H + g * REP + r) * HD + lane * EPL, qf[r]);
  }

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const T* kb = ck + (size_t)g * HD + lane * EPL;
  const T* vb = cv + (size_t)g * HD + lane * EPL;

  for (int base = lo + warp; base < hi; base += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kWarps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (idx < hi && holds) {
        const size_t at = rows(idx);
        load_row<T, EPL>(kb + at, kf[u]);
        load_row<T, EPL>(vb + at, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kWarps;
      if (idx >= hi) break;                               // warp-uniform
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qf[r][e] * kf[u][e];
        s = warp_sum(s) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float pe = expf(s - m_new);
        l[r] = l[r] * alpha + pe;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * alpha + pe * vf[u][e];
        m[r] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes in warp order
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[REP][EPL * 32];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  for (int i = threadIdx.x; i < REP * EPL * 32; i += blockDim.x) (&sm_acc[0][0])[i] = 0.f;
  __syncthreads();
  float f[REP], L[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += sm_l[w][r] * expf(sm_m[w][r] - M);
    L[r] = tot;
    f[r] = expf(m[r] - M);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[r][lane * EPL + e] += acc[r][e] * f[r];
    }
    __syncthreads();
  }
  if (warp == 0 && holds) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      T* o = out + ((size_t)b * H + g * REP + r) * HD + lane * EPL;
      const float inv = 1.f / fmaxf(L[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) from_f(sm_acc[r][lane * EPL + e] * inv, o + e);
    }
  }
}

}  // namespace decode
