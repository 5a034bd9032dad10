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
// small, so one block per (row, kv head) leaves most of the card idle and
// lets the longest row set the time.
//
// Design (decode_common.cuh): a grid of (split, kv head, row); block s takes
// the s-th chunk of the row's keys [max(0, pos-window), min(pos, S)), and a
// block past the last exits at once, which gives the TPU kernel's result
// for pos >= 1 (decode always has pos >= 1). The rep query heads of
// the group share each K/V row the block reads, with 16-byte loads and
// several keys in flight per warp; the splits' fp32 partial softmaxes merge
// in split order in the block that finishes last, so the result does not
// depend on scheduling. The wrapper's decode_plan picks the chunk. Loads go
// straight to registers: no shared-memory ring, TMA or tensor cores, since
// each row is used by rep heads only once.
#include "decode_common.cuh"

namespace {

// Key idx of row b sits at row b*S + idx of the [B, S, KVH, HD] cache.
struct ContiguousRows {
  size_t base, stride;
  __device__ __forceinline__ size_t operator()(int idx) const {
    return (base + idx) * stride;
  }
};

template <typename T, int HD, int REP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                  const T* __restrict__ cv, const int* __restrict__ pos,
                  T* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
                  int S, int KVH, int chunk, int splits, float qscale, float capmul,
                  int window) {
  const int b = blockIdx.z;
  const decode::Span sp = decode::span(pos[b], S, window, chunk, 1, blockIdx.x);
  if (sp.dead) return;
  const ContiguousRows rows{(size_t)b * S, (size_t)KVH * HD};
  decode::attend<T, HD, REP, WARPS>(q, ck, cv, out, part, tickets, KVH, splits, sp, rows,
                             qscale, capmul);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  float* part;
  int* tickets;
  int B, S, KVH, chunk, splits;
  float qscale, capmul;
  int window, warps;
};

template <typename T, int HD, int REP, int WARPS>
cudaError_t launch_w(const Args& a, cudaStream_t stream) {
  dim3 grid(a.splits, a.KVH, a.B);
  gqa_decode_kernel<T, HD, REP, WARPS><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.pos, static_cast<T*>(a.out), a.part, a.tickets, a.S, a.KVH, a.chunk, a.splits,
      a.qscale, a.capmul, a.window);
  return cudaGetLastError();
}

template <typename T, int HD, int REP>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  if (a.warps == 4) return launch_w<T, HD, REP, 4>(a, stream);
  if constexpr (decode::warps_fit(8, REP, HD))
    if (a.warps == 8) return launch_w<T, HD, REP, 8>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t launch_rep(int rep, const Args& a, cudaStream_t s) {
  switch (rep) {
    case 1: return launch_t<T, HD, 1>(a, s);
    case 2: return launch_t<T, HD, 2>(a, s);
    case 4: return launch_t<T, HD, 4>(a, s);
    case 8: return launch_t<T, HD, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(int hd, int rep, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_rep<T, 16>(rep, a, s);
    case 32: return launch_rep<T, 32>(rep, a, s);
    case 64: return launch_rep<T, 64>(rep, a, s);
    case 128: return launch_rep<T, 128>(rep, a, s);
    case 256: return launch_rep<T, 256>(rep, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it). part and
// tickets may be null when splits == 1. warps: 4, or 8 where rep * hd <=
// 1024 (decode::warps_fit). Adds the CUDA kernels it launched
// to *launched.
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* pos, void* out, void* part, void* tickets,
                                 int B, int S, int KVH, int H, int hd, int dtype,
                                 float softcap, int window, int chunk, int splits,
                                 int warps, void* stream, int* launched) {
  if (KVH <= 0 || H % KVH != 0 || B > 65535 || KVH > 65535 || chunk <= 0 || splits <= 0 ||
      splits < decode::splits_needed(S, window, chunk, 1) || (splits > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  // the score scale rounds like the TPU kernel's 1/(hd ** 0.5) taken in fp32
  const float scale = 1.0f / sqrtf((float)hd);
  Args a{q, k, v, static_cast<const int*>(pos), out, static_cast<float*>(part),
         static_cast<int*>(tickets), B, S, KVH, chunk, splits,
         softcap > 0.f ? scale / softcap : scale * decode::kLog2e,
         softcap > 0.f ? softcap * decode::kLog2e : 0.f, window, warps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_hd<float>(hd, rep, a, s);
  if (dtype == 1) err = launch_hd<__nv_bfloat16>(hd, rep, a, s);
  if (err == cudaSuccess) *launched += 1;
  return (int)err;
}
