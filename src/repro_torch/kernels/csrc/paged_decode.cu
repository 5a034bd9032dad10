// paged_gqa_decode: single-token GQA attention over a shared page pool,
// read through per-row block tables.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py::paged_gqa_decode
// (body _paged_kernel): for each row b and query head h, with g = h / rep,
//   out[b,h] = softmax_k(mask(softcap(q[b,h] . K_b[k,g] / sqrt(hd)))) @ V_b[:,g]
// where logical key k of row b lives at kp[tbl[b, k / page], k % page, g, :]
// (vp likewise). Keys are valid where k < pos[b] and pos[b]-1-k < window
// (window 0 = global); scores are softcapped as tanh(s/cap)*cap when cap > 0;
// the softmax runs in fp32 and the output is cast to q's dtype. The pool is
// [n_pages+1, page, KVH, hd]; its last page is the scratch page that sentinel
// table entries name.
//
// What bounds it on an H100: device-memory bytes, as for gqa_decode. Each
// valid key and value row is read once and does 4*hd flops per query head,
// far below the ~295 flops/byte at which the tensor cores become the limit.
// Paging adds one table read per key page, and scatters a row's keys over
// the pool in page-sized runs (page * KVH * hd elements apart per head).
//
// Design: gqa_decode.cu's body (decode_common.cuh), with the address of each
// key resolved through the block table. A grid of (split, kv head, row);
// block s takes the s-th chunk of the row's live keys [max(0, pos-window),
// min(pos, max_pages*page)), counted from the page that holds the first.
// The plan's chunk is a whole number of pages, so a block reads whole pages
// (cut to the live keys) and stages only their table entries (at most
// kMaxChunkPages) in shared memory. A block past the row's last live chunk exits at once; pages
// wholly past pos or wholly before the window are never read (the TPU
// kernel visits all max_pages pages and masks them; the result is the
// same). 16-byte loads, several keys in flight per warp, and the splits'
// fp32 partial softmaxes merge in split order in the block that finishes
// last, so the result does not depend on scheduling. A table entry outside
// [0, n_pages] is clamped into the pool, so a bad table can give a wrong
// answer but never an out-of-bounds read.
#include "decode_common.cuh"

namespace {

// Key idx of the row lives at position idx % page of pool page
// tbl[idx / page]; tbl holds the row's entries from logical page pg_lo on.
struct PagedRows {
  const int* tbl;
  int pg_lo, page;
  size_t stride;
  __device__ __forceinline__ size_t operator()(int idx) const {
    const int lp = idx / page;
    return ((size_t)tbl[lp - pg_lo] * page + (idx - lp * page)) * stride;
  }
};

template <typename T, int HD, int REP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tbl,
                    const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets, int n_total,
                    int page, int max_pages, int KVH, int chunk, int splits, float qscale,
                    float capmul, int window) {
  __shared__ int s_tbl[decode::kMaxChunkPages];
  const int b = blockIdx.z;
  const decode::Span sp = decode::span(pos[b], max_pages * page, window, chunk, page,
                                         blockIdx.x);
  if (sp.dead) return;
  const int pg_lo = sp.k0 / page;
  const int pg_hi = sp.k1 > sp.k0 ? (sp.k1 + page - 1) / page : pg_lo;
  for (int i = pg_lo + threadIdx.x; i < pg_hi; i += blockDim.x)
    s_tbl[i - pg_lo] = min(max(tbl[(size_t)b * max_pages + i], 0), n_total - 1);
  __syncthreads();
  const PagedRows rows{s_tbl, pg_lo, page, (size_t)KVH * HD};
  decode::attend<T, HD, REP, WARPS>(q, kp, vp, out, part, tickets, KVH, splits, sp, rows, qscale,
                             capmul);
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* tbl;
  const int* pos;
  void* out;
  float* part;
  int* tickets;
  int B, n_total, page, max_pages, KVH, chunk, splits;
  float qscale, capmul;
  int window, warps;
};

template <typename T, int HD, int REP, int WARPS>
cudaError_t launch_w(const Args& a, cudaStream_t stream) {
  dim3 grid(a.splits, a.KVH, a.B);
  paged_decode_kernel<T, HD, REP, WARPS><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.tbl, a.pos, static_cast<T*>(a.out), a.part, a.tickets,
      a.n_total, a.page, a.max_pages, a.KVH, a.chunk, a.splits, a.qscale, a.capmul,
      a.window);
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

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). n_total is
// the pool's page count including the scratch page (n_pages + 1). chunk is a
// whole number of pages, at most kMaxChunkPages of them; part and tickets
// may be null when splits == 1; warps: 4, or 8 where rep * hd <= 1024. Adds the CUDA kernels it launched to
// *launched.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tbl, const void* pos, void* out, void* part,
                                   void* tickets, int B, int n_total, int page,
                                   int max_pages, int KVH, int H, int hd, int dtype,
                                   float softcap, int window, int chunk, int splits,
                                   int warps, void* stream, int* launched) {
  if (KVH <= 0 || H % KVH != 0 || B > 65535 || KVH > 65535 || page <= 0 ||
      max_pages <= 0 || n_total <= 0 || chunk <= 0 || chunk % page != 0 ||
      chunk / page > decode::kMaxChunkPages || (long long)max_pages * page > 2147483647LL ||
      splits < decode::splits_needed(max_pages * page, window, chunk, page) ||
      (splits > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  // the score scale rounds like the TPU kernel's 1/(hd ** 0.5) in fp32
  const float scale = 1.0f / sqrtf((float)hd);
  Args a{q, kp, vp, static_cast<const int*>(tbl), static_cast<const int*>(pos), out,
         static_cast<float*>(part), static_cast<int*>(tickets), B, n_total, page, max_pages,
         KVH, chunk, splits,
         softcap > 0.f ? scale / softcap : scale * decode::kLog2e,
         softcap > 0.f ? softcap * decode::kLog2e : 0.f, window, warps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_hd<float>(hd, rep, a, s);
  if (dtype == 1) err = launch_hd<__nv_bfloat16>(hd, rep, a, s);
  if (err == cudaSuccess) *launched += 1;
  return (int)err;
}
