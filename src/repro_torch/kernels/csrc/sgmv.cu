// sgmv: the batched multi-LoRA delta, y[i] = (x[i] @ A[ids[i]]) @ B[ids[i]],
// accumulated in fp32, as one launch per adapted projection.
//
// Replaces the TPU kernel src/repro/kernels/sgmv.py::sgmv_sorted (bodies
// _shrink_kernel and _expand_kernel, reached through sgmv.py::sgmv). The TPU
// version sorts rows by adapter id and pads each group to a block multiple
// with gathers and scatters around two pallas_calls. Here the rows stay where
// they are: a segment table, built once a forward on the card
// (kernels/sgmv.py::sgmv_table), lists them in stable order of their adapter
// slot and cuts each slot's rows into row tiles of BM; `tmap` gives each row
// tile its slot, its live rows and the rows, so a block learns all of it in
// one load. The grid has a static bound, R // BM + min(T, R) row tiles (as
// the JAX wrapper's Rp = pad(R, BM) + T * BM), so the launch needs no count
// from the card; tiles past the last live one exit at once.
//
// What bounds it on an H100: device-memory bytes, and at decode's few rows
// latency (PERF.md: at R=16 it runs at 0.04-0.12 of its bytes bound, the
// time a chain of launch, row-tile load, one load round trip, the cluster
// barrier and the y read-modify-write). At rank 16 every shape on the serving path is
// far below the card's fp32 balance (~20 operations a byte): mlp_in at R=16
// does 3.6 MFLOP on 2.27 MB, about 1.6 a byte. So the kernel moves each byte
// once, keeps its intermediates on the chip, and puts one load round trip
// on its critical path. It uses fp32 FMAs, not tensor cores: they would not
// help a bytes-bound kernel, and TF32 would give up the fp32 tolerance that
// the JAX reference and sgmv_ref are held to.
//
// Design: one row tile (BM rows of one adapter) per thread-block cluster of C
// blocks (2-8, cudaLaunchKernelEx). Block c of the cluster owns dout columns
// [ct*BN, ct*BN + BN), ct = blockIdx.x, and 1/C of the d axis:
//  1. shrink: its x rows (gathered through tmap) and A rows of its d slice
//     arrive by 16-byte cp.async, the whole slice in one chunk where it
//     fits (decode: one load round trip), else through a 4-stage ring of
//     KC-element chunks. Each thread keeps fp32 partials of a few (row,
//     4 ranks) pairs over its share of each chunk; the shares are summed in
//     a fixed order;
//  2. its adapter's B tile [r, BN] lands in shared memory by cp.async,
//     issued behind the first chunks;
//  3. each block stores its partial h [BM, r] into its own slot of every
//     cluster block's shared memory (distributed shared memory,
//     map_shared_rank); after one cluster barrier each block sums the C
//     slots in rank order, so all hold the same h and h never leaves the
//     chip;
//  4. expand: each thread holds one 4-column quad of the B tile in registers
//     for all r and walks the tile's rows, four at a time,
//     y[row, quad] = h[row] @ B[:, quad];
//  5. epilogue, a template parameter: ADD = false writes the fp32 product
//     (sgmv); ADD = true updates y in place, y = round_y(y + round_x(s * acc))
//     with __fmul_rn and __fadd_rn, no FMA contraction, so it is bit-equal to
//     the fp32 product followed by `* s`, `.to(x.dtype)` and `y + d` in torch.
// Every sum runs in a fixed order, so two calls give the same bits; there are
// no atomics and no scratch in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;       // ring stages of the shrink
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxBM = 64;
constexpr int kRowBatch = 4;     // rows whose y quads one thread loads together

// Shared-memory layout, in bytes; kernels/sgmv.py::smem_bytes mirrors it.
struct Layout {
  int b, x, a, gather, h, red, total;
};

// The ring's stages: kStages, or fewer when the d slice takes fewer chunks.
__host__ __device__ inline int ring_stages(int dc, int kc) {
  const int nk = (dc + kc - 1) / kc;
  return nk < 1 ? 1 : nk < kStages ? nk : kStages;
}

__host__ __device__ inline Layout layout(int bm, int bn, int kc, int stages, int rk,
                                         int xbytes, int cluster) {
  const int xrow = kc * xbytes + 16;           // +16: rows start on other banks
  const int pairs = bm * (rk / 4);
  Layout l;
  l.b = 0;
  l.x = l.b + rk * bn * 4;
  l.a = l.x + stages * bm * xrow;
  l.gather = l.a + stages * kc * rk * 4;
  l.h = l.gather + cluster * pairs * 16;
  l.red = l.h + pairs * 16;
  l.total = l.red + (pairs > kThreads ? pairs : kThreads) * 16;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of x from shared memory as fp32
__device__ __forceinline__ void load_x(const unsigned char* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load_x(const unsigned char* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float4 fma4(float s, float4 w, float4 acc) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
  return acc;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the epilogues: store the fp32 product, or add it into y, scaled and
// rounded as torch rounds `y + (s * acc).to(x.dtype)`; y moves as quads of
// 4 elements (16 bytes in fp32, 8 in bf16)
template <typename X> struct Quad;
template <> struct Quad<float> { using T = float4; };
template <> struct Quad<__nv_bfloat16> { using T = uint2; };

__device__ __forceinline__ float4 add_quad(float4 v, float4 acc, float s) {
  v.x = __fadd_rn(v.x, __fmul_rn(acc.x, s));
  v.y = __fadd_rn(v.y, __fmul_rn(acc.y, s));
  v.z = __fadd_rn(v.z, __fmul_rn(acc.z, s));
  v.w = __fadd_rn(v.w, __fmul_rn(acc.w, s));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 add_bf16(__nv_bfloat16 y, float acc, float s) {
  const __nv_bfloat16 d = __float2bfloat16_rn(__fmul_rn(acc, s));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(d)));
}
__device__ __forceinline__ uint2 add_quad(uint2 u, float4 acc, float s) {
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&u);
  v[0] = add_bf16(v[0], acc.x, s);
  v[1] = add_bf16(v[1], acc.y, s);
  v[2] = add_bf16(v[2], acc.z, s);
  v[3] = add_bf16(v[3], acc.w, s);
  return u;
}

// U rows of the expand for one column quad n: y[row] = h[m] @ B[:, quad]
// for m = m0, m0 + step, ...; the U rows' y quads load first (ADD), then
// their FMA chains run side by side, then the epilogue stores them.
template <typename X, int RK, bool ADD, int U>
__device__ __forceinline__ void expand_rows(const float4* h4, const float4 (&bq)[RK],
                                            const int* rows, int m0, int step, void* out,
                                            int dout, int n, float scaling) {
  constexpr int R4 = RK / 4;
  typename Quad<X>::T yq[U];
  size_t at[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    at[u] = static_cast<size_t>(rows[m0 + u * step]) * dout + n;
    if constexpr (ADD)
      yq[u] = *reinterpret_cast<const typename Quad<X>::T*>(static_cast<const X*>(out) + at[u]);
  }
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int jq = 0; jq < R4; ++jq) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 hv = h4[(m0 + u * step) * R4 + jq];
      acc[u] = fma4(hv.x, bq[4 * jq], acc[u]);
      acc[u] = fma4(hv.y, bq[4 * jq + 1], acc[u]);
      acc[u] = fma4(hv.z, bq[4 * jq + 2], acc[u]);
      acc[u] = fma4(hv.w, bq[4 * jq + 3], acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if constexpr (ADD)
      *reinterpret_cast<typename Quad<X>::T*>(static_cast<X*>(out) + at[u]) =
          add_quad(yq[u], acc[u], scaling);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at[u]) = acc[u];
  }
}

// X: the rows' dtype (float or bf16); RK: the LoRA rank; ADD: the epilogue.
// out is float [R, dout] (ADD false) or X [R, dout] (ADD true, in place).
// tmap: [row_tiles, bm + 2] int32, per row tile its slot (-1: no rows), its
// live rows and the rows. dc: the d elements of one cluster rank, kc: of one
// ring stage (multiples of 8 and 16).
template <typename X, int RK, bool ADD>
__global__ void __launch_bounds__(kThreads)
sgmv_kernel(const X* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ b, const int* __restrict__ tmap,
            void* __restrict__ out, int d, int dout, int dc, int kc, int bm, int bn,
            float scaling) {
  constexpr int R4 = RK / 4;                  // rank quads
  constexpr int TQ = kThreads / R4;           // threads on one rank quad
  constexpr int PER = 16 / sizeof(X);         // x elements in 16 bytes
  constexpr int MPT = kMaxBM / TQ > 1 ? kMaxBM / TQ : 1;  // rows a thread, at most

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_map[kMaxBM + 2];           // slot, live rows, the rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;

  // -- the row tile, in one load (the whole cluster shares blockIdx.y, so a
  //    tile without rows sends the whole cluster away)
  if (tid < bm + 2) s_map[tid] = tmap[static_cast<size_t>(blockIdx.y) * (bm + 2) + tid];
  __syncthreads();
  const int slot = s_map[0];
  if (slot < 0) return;
  const int live = s_map[1];
  const int* rows = s_map + 2;
  cluster_arrive_relaxed();             // waited for before the first remote store

  const int ns = ring_stages(dc, kc);
  const Layout L = layout(bm, bn, kc, ns, RK, sizeof(X), C);
  float* Bs = reinterpret_cast<float*>(smem + L.b);
  float4* gather4 = reinterpret_cast<float4*>(smem + L.gather);
  float4* h4 = reinterpret_cast<float4*>(smem + L.h);
  float4* red4 = reinterpret_cast<float4*>(smem + L.red);
  const int xrow = kc * static_cast<int>(sizeof(X)) + 16;
  const int xp = kc / PER;                    // 16-byte pieces of a row chunk
  const int pairs = bm * R4;

  const int k0 = rank * dc;
  const int k1 = min(d, k0 + dc);
  const int nk = k1 > k0 ? (k1 - k0 + kc - 1) / kc : 0;
  const int n0 = blockIdx.x * bn;
  const bool has_cols = n0 < dout;
  const float* ag = a + static_cast<size_t>(slot) * d * RK;

  auto issue_chunk = [&](int i) {
    if (i >= nk) return;
    const int kb0 = k0 + i * kc;
    const int st = i % ns;
    float* as = reinterpret_cast<float*>(smem + L.a) + st * kc * RK;
    unsigned char* xs = smem + L.x + st * bm * xrow;
    for (int p = tid; p < kc * R4; p += kThreads) {
      const int k = kb0 + p / R4;
      const bool ok = k < k1;
      cp_async16(as + p * 4, ok ? ag + static_cast<size_t>(k) * RK + (p % R4) * 4 : ag, ok);
    }
    for (int p = tid; p < bm * xp; p += kThreads) {
      const int m = p / xp;
      const int k = kb0 + (p % xp) * PER;
      const bool ok = m < live && k < k1;
      const X* src = ok ? x + static_cast<size_t>(rows[m]) * d + k : x;
      cp_async16(xs + m * xrow + (p % xp) * 16, src, ok);
    }
  };

  // -- ring prologue: stages 0..kStages-2, then the B tile
  for (int i = 0; i < kStages - 1; ++i) {
    issue_chunk(i);
    cp_async_commit();
  }
  if (has_cols) {
    const int nq = bn / 4;
    const float* bg = b + static_cast<size_t>(slot) * RK * dout;
    for (int p = tid; p < RK * nq; p += kThreads) {
      const int j = p / nq;
      const int n = n0 + (p % nq) * 4;
      const bool ok = n < dout;
      cp_async16(Bs + p * 4, ok ? bg + static_cast<size_t>(j) * dout + n : bg, ok);
    }
  }
  cp_async_commit();

  // -- shrink over this rank's d slice
  const int q = tid % R4;
  const int rest = tid / R4;
  const int G = TQ >= bm ? TQ / bm : 1;       // threads sharing one (row, quad)
  const int g = TQ >= bm ? rest / bm : 0;
  const int m0 = TQ >= bm ? rest % bm : rest;
  float4 acc[MPT];
#pragma unroll
  for (int s = 0; s < MPT; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < nk; ++i) {
    // groups so far: chunks 0..kStages-2, B, then one a loop turn
    if (i < kStages - 1) cp_async_wait<kStages - 1>();
    else cp_async_wait<kStages - 2>();
    __syncthreads();
    issue_chunk(i + kStages - 1);       // into the stage turn i-1 read (none
    cp_async_commit();                  // when the slice fits fewer stages)
    const int st = i % ns;
    const float4* as4 = reinterpret_cast<const float4*>(smem + L.a) + st * kc * R4;
    const unsigned char* xs = smem + L.x + st * bm * xrow;
    for (int kb = g; kb < xp; kb += G) {
      float4 w[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) w[e] = as4[(kb * PER + e) * R4 + q];
#pragma unroll
      for (int s = 0; s < MPT; ++s) {
        const int m = m0 + s * TQ;
        if (m < live && (s == 0 || TQ < bm)) {
          float xv[PER];
          load_x(xs + m * xrow + kb * 16, xv);
#pragma unroll
          for (int e = 0; e < PER; ++e) acc[s] = fma4(xv[e], w[e], acc[s]);
        }
      }
    }
  }
  // the shares of each (row, quad), summed in share order
#pragma unroll
  for (int s = 0; s < MPT; ++s) {
    const int m = m0 + s * TQ;
    if (m < bm && (s == 0 || TQ < bm)) red4[(g * bm + m) * R4 + q] = acc[s];
  }
  __syncthreads();

  // -- the cluster's partials: each block stores its own into slot `rank` of
  //    every block's gather buffer (distributed shared memory), one cluster
  //    barrier, then each block sums the C slots in rank order from its own
  //    shared memory; after the barrier no block touches another's memory.
  //    (The first wait only makes sure every block of the cluster runs.)
  cluster_wait();
  for (int idx = tid; idx < pairs; idx += kThreads) {
    float4 sum = red4[idx];
    for (int gg = 1; gg < G; ++gg) sum = add4(sum, red4[gg * pairs + idx]);
    for (int c = 0; c < C; ++c) cluster.map_shared_rank(gather4, c)[rank * pairs + idx] = sum;
  }
  cluster_arrive();
  cluster_wait();
  for (int idx = tid; idx < pairs; idx += kThreads) {
    float4 sum = gather4[idx];
    for (int c = 1; c < C; ++c) sum = add4(sum, gather4[c * pairs + idx]);
    h4[idx] = sum;
  }
  cp_async_wait<0>();
  __syncthreads();

  // -- expand: one column quad a thread, its B column in registers
  if (has_cols) {
    const int nq = bn / 4;
    const int rg = tid / nq;
    const int groups = kThreads / nq;
    const int n = n0 + (tid % nq) * 4;
    if (n < dout) {
      float4 bq[RK];
#pragma unroll
      for (int j = 0; j < RK; ++j)
        bq[j] = reinterpret_cast<const float4*>(Bs)[j * nq + tid % nq];
      // rows in batches of kRowBatch: a full batch loads its y quads
      // together and runs its rows' FMA chains side by side
      for (int mb = rg; mb < live; mb += kRowBatch * groups) {
        if (mb + (kRowBatch - 1) * groups < live)
          expand_rows<X, RK, ADD, kRowBatch>(h4, bq, rows, mb, groups, out, dout, n, scaling);
        else
          for (int m = mb; m < live; m += groups)
            expand_rows<X, RK, ADD, 1>(h4, bq, rows, m, groups, out, dout, n, scaling);
      }
    }
  }
}

template <typename X, int RK, bool ADD>
cudaError_t launch_t(const void* x, const float* a, const float* b, const int* tmap,
                     void* out, int d, int dout, float scaling, int bm, int bn, int kc,
                     int cluster, int row_tiles, cudaStream_t stream) {
  auto kern = sgmv_kernel<X, RK, ADD>;
  const int dc = ((d + cluster - 1) / cluster + 7) / 8 * 8;
  const int smem = layout(bm, bn, kc, ring_stages(dc, kc), RK, sizeof(X), cluster).total;
  static int opted = 48 * 1024;         // per instantiation
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int tiles_n = (dout + bn - 1) / bn;
  const int groups = (tiles_n + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cluster, row_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, static_cast<const X*>(x), a, b, tmap,
                                       out, d, dout, dc, kc, bm, bn, scaling);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename X, bool ADD>
cudaError_t by_rank(int r, const void* x, const float* a, const float* b, const int* tmap,
                    void* out, int d, int dout, float scaling, int bm, int bn, int kc,
                    int cluster, int row_tiles, cudaStream_t s) {
  switch (r) {
    case 4:
      return launch_t<X, 4, ADD>(x, a, b, tmap, out, d, dout, scaling, bm, bn, kc, cluster,
                                 row_tiles, s);
    case 8:
      return launch_t<X, 8, ADD>(x, a, b, tmap, out, d, dout, scaling, bm, bn, kc, cluster,
                                 row_tiles, s);
    case 16:
      return launch_t<X, 16, ADD>(x, a, b, tmap, out, d, dout, scaling, bm, bn, kc,
                                  cluster, row_tiles, s);
    case 32:
      return launch_t<X, 32, ADD>(x, a, b, tmap, out, d, dout, scaling, bm, bn, kc,
                                  cluster, row_tiles, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [R, d] rows (x_dtype 0 = float32, 1 = bfloat16); a: [T, d, r] and b:
// [T, r, dout] float32; tmap: [row_tiles, bm + 2] int32, the segment table's
// row tiles; out: float32 [R, dout] (add 0) or x's dtype [R, dout], updated
// in place (add 1). bm, bn, kc, cluster and row_tiles come from
// kernels/sgmv.py::sgmv_plan. Requires r in {4, 8, 16, 32}, d % 8 == 0,
// dout % 4 == 0, kc % 16 == 0, 16-byte aligned x, a, b and out. Adds the
// CUDA kernels it launched (one, or none when there is no row) to *launched.
extern "C" int sgmv_launch(const void* x, const void* a, const void* b, const void* tmap,
                           void* out, int R, int d, int r, int dout, int x_dtype, int add,
                           float scaling, int bm, int bn, int kc, int cluster,
                           int row_tiles, void* stream, int* launched) {
  if ((bm != 16 && bm != 32 && bm != 64) || bn < 64 || bn > 1024 || (bn & (bn - 1)) ||
      cluster < 1 || cluster > kMaxCluster || r * bn > 16384 || d % 8 || dout % 4 ||
      kc < 16 || kc % 16 || row_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || row_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* tm = static_cast<const int*>(tmap);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && add == 0)
    err = by_rank<float, false>(r, x, af, bf, tm, out, d, dout, scaling, bm, bn, kc,
                                cluster, row_tiles, s);
  else if (x_dtype == 0 && add == 1)
    err = by_rank<float, true>(r, x, af, bf, tm, out, d, dout, scaling, bm, bn, kc,
                               cluster, row_tiles, s);
  else if (x_dtype == 1 && add == 0)
    err = by_rank<__nv_bfloat16, false>(r, x, af, bf, tm, out, d, dout, scaling, bm, bn,
                                        kc, cluster, row_tiles, s);
  else if (x_dtype == 1 && add == 1)
    err = by_rank<__nv_bfloat16, true>(r, x, af, bf, tm, out, d, dout, scaling, bm, bn,
                                       kc, cluster, row_tiles, s);
  if (err == cudaSuccess) *launched += 1;
  return (int)err;
}
