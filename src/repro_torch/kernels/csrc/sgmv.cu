// sgmv: multi-LoRA grouped matmul, y[i] = (x[i] @ A[ids[i]]) @ B[ids[i]] in fp32.
//
// Replaces the TPU kernel src/repro/kernels/sgmv.py::sgmv_sorted (bodies
// _shrink_kernel and _expand_kernel, reached through sgmv.py::sgmv). The TPU
// version sorts rows by adapter id and pads each group to a block multiple so
// that every matrix-unit tile belongs to one adapter. That layout is not
// carried over: here every row gathers its own adapter by ids[i] directly, as
// Punica's SGMV does on GPUs, so there is no sort, no padding and no
// scatter back, and an adapter with no rows costs nothing and touches no
// neighbour.
//
// What bounds it on an H100: device-memory bytes. The rank r is small (16 on
// the serving path), so each row does 2*r flops per element of x, A and B it
// touches; x is read once, each adapter's A and B once from device memory
// (rows of the same adapter meet them again in the 50 MB L2), y written once.
// Decode has few rows, so the work has to be cut finer than one block per
// row to occupy the 132 SMs.
//
// Design: two launches, as Punica's shrink/expand split.
//  shrink: grid (R, ksplit). Block (i, s) reduces its slice of the d axis,
//          h_part[s, i, :] = x[i, slice] @ A[ids[i], slice, :]. Threads read A
//          as float4 rows of r/4 vectors, so a warp reads contiguous memory;
//          the partial sums are combined through shared memory in a fixed
//          order. ksplit grows as R shrinks, to keep about two blocks per SM.
//  expand: grid (R, ceil(dout/1024)). Block (i, n) first sums the ksplit
//          partials of h[i] in order, then each thread writes four outputs
//          y[i, n4*4 .. n4*4+3] = h[i] @ B[ids[i], :, cols] from float4 loads.
// Accumulation is fp32 throughout and the order is fixed, so results do not
// depend on scheduling. Tensor cores (mma/wgmma over row tiles of one
// adapter) are left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename X>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink(const X* __restrict__ x, const float* __restrict__ a,
            const int* __restrict__ ids, float* __restrict__ h_part, int R, int d,
            int r, int dc) {
  const int i = blockIdx.x;
  const int s = blockIdx.y;
  const int t = ids[i];
  const int k0 = s * dc;
  const int k1 = min(d, k0 + dc);
  const int r4 = r >> 2;
  const int rows_per = kThreads / r4;          // k rows covered per sweep
  const int tid = threadIdx.x;
  const int jq = tid % r4;
  const int kr = tid / r4;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kr < rows_per) {
    const X* xr = x + (size_t)i * d;
    const float4* a4 = reinterpret_cast<const float4*>(a + (size_t)t * d * r);
    for (int k = k0 + kr; k < k1; k += rows_per) {
      const float xv = to_f(xr[k]);
      const float4 w = a4[(size_t)k * r4 + jq];
      acc.x += xv * w.x;
      acc.y += xv * w.y;
      acc.z += xv * w.z;
      acc.w += xv * w.w;
    }
  }
  __shared__ float4 red[kThreads];
  red[tid] = acc;
  __syncthreads();
  for (int j = tid; j < r; j += kThreads) {
    const int q = j >> 2;
    const int c = j & 3;
    float sum = 0.f;
    for (int k = 0; k < rows_per; ++k) {
      const float4 v = red[k * r4 + q];
      sum += c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
    }
    h_part[((size_t)s * R + i) * r + j] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
sgmv_expand(const float* __restrict__ h_part, const float* __restrict__ b,
            const int* __restrict__ ids, float* __restrict__ y, int R, int r,
            int dout, int ksplit) {
  const int i = blockIdx.x;
  const int t = ids[i];
  __shared__ float hs[kMaxRank];
  for (int j = threadIdx.x; j < r; j += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < ksplit; ++s) sum += h_part[((size_t)s * R + i) * r + j];
    hs[j] = sum;
  }
  __syncthreads();
  const int n4 = blockIdx.y * kThreads + threadIdx.x;
  const int d4 = dout >> 2;
  if (n4 >= d4) return;
  const float4* b4 = reinterpret_cast<const float4*>(b + (size_t)t * r * dout);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < r; ++j) {
    const float4 w = b4[(size_t)j * d4 + n4];
    const float hv = hs[j];
    acc.x += hv * w.x;
    acc.y += hv * w.y;
    acc.z += hv * w.z;
    acc.w += hv * w.w;
  }
  reinterpret_cast<float4*>(y + (size_t)i * dout)[n4] = acc;
}

template <typename X>
cudaError_t launch_t(const void* x, const float* a, const float* b, const int* ids,
                     float* h_part, float* y, int R, int d, int r, int dout, int ksplit,
                     cudaStream_t stream) {
  const int dc = (d + ksplit - 1) / ksplit;
  sgmv_shrink<X><<<dim3(R, ksplit), kThreads, 0, stream>>>(
      static_cast<const X*>(x), a, ids, h_part, R, d, r, dc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int d4 = dout / 4;
  sgmv_expand<<<dim3(R, (d4 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      h_part, b, ids, y, R, r, dout, ksplit);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. a, b, h_part and y are float32.
// Requires r % 4 == 0, r <= 256, dout % 4 == 0 and 16-byte aligned a, b, y.
extern "C" int sgmv_launch(const void* x, const void* a, const void* b, const void* ids,
                           void* h_part, void* y, int R, int d, int r, int dout,
                           int ksplit, int x_dtype, void* stream) {
  if (r % 4 != 0 || r > kMaxRank || r <= 0 || dout % 4 != 0 || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* id = static_cast<const int*>(ids);
  float* hp = static_cast<float*>(h_part);
  float* yf = static_cast<float*>(y);
  if (x_dtype == 0)
    return (int)launch_t<float>(x, af, bf, id, hp, yf, R, d, r, dout, ksplit, s);
  if (x_dtype == 1)
    return (int)launch_t<__nv_bfloat16>(x, af, bf, id, hp, yf, R, d, r, dout, ksplit, s);
  return (int)cudaErrorInvalidValue;
}
