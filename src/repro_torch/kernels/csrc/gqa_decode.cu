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
// the result does not depend on scheduling. The body is decode_common.cuh's,
// shared with paged_decode.cu. Split-K across blocks, TMA and wgmma are left
// for later work.
#include "decode_common.cuh"

namespace {

using decode::kWarps;

// Key idx of row b sits at row b*S + idx of the [B, S, KVH, HD] cache.
struct ContiguousRows {
  size_t base, stride;
  __device__ __forceinline__ size_t operator()(int idx) const {
    return (base + idx) * stride;
  }
};

template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kWarps * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                  const T* __restrict__ cv, const int* __restrict__ pos,
                  T* __restrict__ out, int S, int KVH, float scale,
                  float softcap, int window) {
  const int b = blockIdx.y;
  const int p = pos[b];
  const int hi = min(p, S);
  const int lo = window > 0 ? max(0, p - window) : 0;
  const ContiguousRows rows{(size_t)b * S, (size_t)KVH * HD};
  decode::attend<T, HD, REP>(q, ck, cv, out, KVH, lo, hi, rows, scale, softcap);
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
