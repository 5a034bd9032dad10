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
// key resolved through the block table. One block per (row, kv head); the
// rep query heads of the group share each K/V row the block reads. The block
// first copies the table entries it needs (logical pages [lo/page,
// ceil(hi/page)), with [lo, hi) = [max(0, pos-window),
// min(pos, max_pages*page))) into shared memory, so pages wholly past pos or
// wholly before the window are never read (the TPU kernel visits all
// max_pages pages and masks them; the result is the same). Each of the 8
// warps walks its own keys (warp w takes keys lo+w, lo+w+8, ...), every lane
// holding ceil(hd/32) contiguous elements, four keys loaded before any is
// used, with its own fp32 online softmax in registers; the warps' partial
// softmaxes merge through shared memory in a fixed order, so the result does
// not depend on scheduling. A table entry
// outside [0, n_pages] is clamped into the pool, so a bad table can give a
// wrong answer but never an out-of-bounds read. Split-K across blocks, TMA
// and wgmma are left for later work.
#include "decode_common.cuh"

namespace {

using decode::kWarps;

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

// Dynamic shared memory: the row's live block-table entries (max_pages ints
// at most).
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tbl,
                    const int* __restrict__ pos, T* __restrict__ out, int n_total,
                    int page, int max_pages, int KVH, float scale, float softcap,
                    int window) {
  extern __shared__ int s_tbl[];
  const int b = blockIdx.y;
  const int p = pos[b];
  const int hi = min(p, max_pages * page);
  const int lo = window > 0 ? max(0, p - window) : 0;
  const int pg_lo = lo / page;
  const int pg_hi = hi > lo ? (hi + page - 1) / page : pg_lo;
  for (int i = pg_lo + threadIdx.x; i < pg_hi; i += blockDim.x)
    s_tbl[i - pg_lo] = min(max(tbl[(size_t)b * max_pages + i], 0), n_total - 1);
  __syncthreads();
  const PagedRows rows{s_tbl, pg_lo, page, (size_t)KVH * HD};
  decode::attend<T, HD, REP>(q, kp, vp, out, KVH, lo, hi, rows, scale, softcap);
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* tbl;
  const int* pos;
  void* out;
  int B, n_total, page, max_pages, KVH;
  float scale, softcap;
  int window;
};

template <typename T, int HD, int REP>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  dim3 grid(a.KVH, a.B);
  const size_t smem = (size_t)a.max_pages * sizeof(int);
  paged_decode_kernel<T, HD, REP><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.tbl, a.pos, static_cast<T*>(a.out), a.n_total,
      a.page, a.max_pages, a.KVH, a.scale, a.softcap, a.window);
  return cudaGetLastError();
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
// the pool's page count including the scratch page (n_pages + 1).
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tbl, const void* pos, void* out, int B,
                                   int n_total, int page, int max_pages, int KVH, int H,
                                   int hd, int dtype, float softcap, int window,
                                   void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || max_pages <= 0 || n_total <= 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  Args a{q, kp, vp, static_cast<const int*>(tbl), static_cast<const int*>(pos), out,
         B, n_total, page, max_pages, KVH,
         // the score scale rounds like the TPU kernel's 1/(hd ** 0.5) in fp32
         1.0f / sqrtf((float)hd), softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hd<float>(hd, rep, a, s);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(hd, rep, a, s);
  return (int)cudaErrorInvalidValue;
}
