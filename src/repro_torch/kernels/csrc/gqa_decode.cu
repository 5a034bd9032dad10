// gqa_decode: single-token GQA attention over a contiguous KV cache.
//
// Replaces the TPU kernel src/repro/kernels/gqa_decode.py::gqa_decode
// (body _decode_kernel): for each row b and query head h,
//   out[b,h] = softmax_k(mask(softcap(q[b,h] . K[b,k,g] / sqrt(hd)))) @ V[b,:,g]
// with g = h / rep, keys valid where idx < pos[b] and pos[b]-1-idx < window
// (window 0 = global), scores softcapped as tanh(s/cap)*cap when cap > 0,
// softmax in fp32 and the output cast to q's dtype.
//
// What bounds it on an H100: device-memory bytes. Every valid key and value
// row is read once and does 4*hd flops per query head, far below the ~295
// flops/byte at which the tensor cores become the limit. Decode batches are
// small, so there are few (row, kv head) pairs to spread over 132 SMs.
//
// Design: one block per (row, kv head); the rep query heads of the group
// share each K/V row the block reads, so the cache is read once and not rep
// times. Each warp walks its own keys (warp w takes keys lo+w, lo+w+8, ...),
// one key per warp step with every lane holding ceil(hd/32) contiguous elements,
// and keeps its own fp32 online softmax (running max, sum and weighted
// accumulator) in registers. Four keys per warp step are loaded before any
// is used, so each warp keeps several loads in flight. The block skips keys
// outside [max(0, pos-window), min(pos, S)), which gives the TPU kernel's
// result for pos >= 1 (decode always has pos >= 1). At the end the warps'
// partial softmaxes are merged through shared memory in a fixed order, so
// the result does not depend on scheduling. Split-K across blocks, TMA and
// wgmma are left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// HD = head dim; each lane holds EPL = ceil(HD/32) contiguous elements of a
// row, and for HD = 16 only lanes 0..15 hold any (the rest hold zeros).
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kWarps * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                  const T* __restrict__ cv, const int* __restrict__ pos,
                  T* __restrict__ out, int S, int KVH, float scale,
                  float softcap, int window) {
  constexpr int EPL = (HD + 31) / 32;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = KVH * REP;
  const bool holds = lane * EPL < HD;

  const int p = pos[b];
  const int hi = min(p, S);
  const int lo = window > 0 ? max(0, p - window) : 0;

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

  const size_t row_stride = (size_t)KVH * HD;            // one cache position
  const T* kb = ck + (size_t)b * S * row_stride + (size_t)g * HD + lane * EPL;
  const T* vb = cv + (size_t)b * S * row_stride + (size_t)g * HD + lane * EPL;

  for (int base = lo + warp; base < hi; base += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kWarps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (idx < hi && holds) {
        load_row<T, EPL>(kb + idx * row_stride, kf[u]);
        load_row<T, EPL>(vb + idx * row_stride, vf[u]);
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

template <typename T, int HD, int REP>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* pos,
                     void* out, int B, int S, int KVH, float scale, float softcap,
                     int window, cudaStream_t stream) {
  dim3 grid(KVH, B);
  gqa_decode_kernel<T, HD, REP><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, static_cast<T*>(out), S, KVH, scale, softcap, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rep(int rep, const void* q, const void* k, const void* v,
                       const int* pos, void* out, int B, int S, int KVH, float scale,
                       float softcap, int window, cudaStream_t s) {
  switch (rep) {
    case 1: return launch_t<T, HD, 1>(q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 2: return launch_t<T, HD, 2>(q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 4: return launch_t<T, HD, 4>(q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 8: return launch_t<T, HD, 8>(q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(int hd, int rep, const void* q, const void* k, const void* v,
                      const int* pos, void* out, int B, int S, int KVH, float scale,
                      float softcap, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_rep<T, 16>(rep, q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 32: return launch_rep<T, 32>(rep, q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 64: return launch_rep<T, 64>(rep, q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 128: return launch_rep<T, 128>(rep, q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    case 256: return launch_rep<T, 256>(rep, q, k, v, pos, out, B, S, KVH, scale, softcap, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* pos, void* out, int B, int S, int KVH,
                                 int H, int hd, int dtype, float softcap, int window,
                                 void* stream) {
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  // the score scale rounds like the TPU kernel's 1/(hd ** 0.5) taken in fp32
  const float scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, rep, q, k, v, p, out, B, S, KVH, scale, softcap, window, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, rep, q, k, v, p, out, B, S, KVH, scale, softcap,
                                         window, s);
  return (int)cudaErrorInvalidValue;
}
