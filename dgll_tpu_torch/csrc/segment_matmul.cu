// Weighted CSR SpMM with fused bias and ReLU, for Hopper (sm_90a).
//
//   out[r, :] = act(sum_{e in row r} w[e] * x[src[e], :] + bias)
//
// with f32 accumulation, stored in the output type (f32, or bf16 for bf16 input).
//
// Replaces the TPU kernel dgll_tpu/ops/pallas/segment_matmul.py (_kernel, launched
// by spmm_chunked_pallas). That kernel packs edges into 512-slot chunks per 128-row
// block and turns each chunk into a one-hot [128, 512] x [512, F] matrix product,
// because the TPU has no atomics and runs its grid in order. This kernel computes
// the same function from a plain dst-major CSR instead.
//
// Design: one warp per destination row. The lanes run across the feature columns;
// each lane keeps VEC consecutive columns as f32 sums in registers and reads
// x[src, col:col+VEC] with one VEC-wide load (16 bytes where F and the pointer
// allow). The warp reads its row's src and w 32 edges at a time, coalesced, and
// broadcasts them lane to lane with shuffles. gridDim.y tiles F in 32*VEC columns
// and the ragged last tile is masked. There are no atomics: each output element is
// summed by one lane in edge order, so results are bitwise repeatable.
//
// What bounds it: memory bytes. A call reads E*F*itemsize bytes of gathered source
// rows (x does not fit the 50 MB L2 at the full-graph sizes), 8 bytes of index and
// weight per edge and feature tile, and writes n_rows*F*out_itemsize bytes. The
// unrolled edge loop keeps several row loads in flight per warp.
//
// Known long tail, left for a later change: a hub row is walked by one warp alone,
// so on a power-law graph the largest in-degree puts a floor under the kernel's
// time. Splitting hub rows over several warps, with a second reduction pass, is the
// fix. Narrow F (the output layer) also leaves lanes idle: one warp per row reads
// only F*itemsize bytes per edge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive elements moved with one load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename TIn, typename TOut, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                const float* __restrict__ weight, const TIn* __restrict__ x,
                const float* __restrict__ bias, TOut* __restrict__ out,
                int n_rows, int f, int relu) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the same for the whole warp
  const int col = (blockIdx.y * 32 + lane) * VEC;
  // F % VEC == 0, so a lane holds all VEC of its columns or none.
  const bool active = col < f;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int s = 0;
    float w = 0.f;
    if (e < end) {
      s = src[e];
      w = weight[e];
    }
    const int n = min(32, end - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int sj = __shfl_sync(0xffffffffu, s, j);
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (active) {
        const Pack<TIn, VEC> p =
            *reinterpret_cast<const Pack<TIn, VEC>*>(x + (int64_t)sj * f + col);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wj, to_float(p.v[k]), acc[k]);
      }
    }
  }
  if (!active) return;

  Pack<TOut, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float v = acc[k];
    if (bias != nullptr) v += bias[col + k];
    if (relu) v = fmaxf(v, 0.f);
    o.v[k] = from_float<TOut>(v);
  }
  *reinterpret_cast<Pack<TOut, VEC>*>(out + (int64_t)row * f + col) = o;
}

template <typename TIn, typename TOut, int VEC>
cudaError_t launch(const void* indptr, const void* src, const void* weight,
                   const void* x, const void* bias, void* out, int n_rows, int f,
                   int relu, cudaStream_t stream) {
  const int cols_per_warp = 32 * VEC;
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + cols_per_warp - 1) / cols_per_warp);
  spmm_csr_kernel<TIn, TOut, VEC><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(src),
      static_cast<const float*>(weight), static_cast<const TIn*>(x),
      static_cast<const float*>(bias), static_cast<TOut*>(out), n_rows, f, relu);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_vec(int vec, const void* indptr, const void* src,
                       const void* weight, const void* x, const void* bias,
                       void* out, int n_rows, int f, int relu,
                       cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<TIn, TOut, 1>(indptr, src, weight, x, bias, out, n_rows, f, relu, stream);
    case 2:
      return launch<TIn, TOut, 2>(indptr, src, weight, x, bias, out, n_rows, f, relu, stream);
    case 4:
      return launch<TIn, TOut, 4>(indptr, src, weight, x, bias, out, n_rows, f, relu, stream);
    case 8:
      return launch<TIn, TOut, 8>(indptr, src, weight, x, bias, out, n_rows, f, relu, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Supported (in, out) pairs: (0, 0),
// (1, 1), (1, 0). bias is float32 or null. Returns cudaGetLastError() after the
// launch; nothing is launched when a check fails.
int dgll_spmm_csr(const void* indptr, const void* src, const void* weight,
                  const void* x, const void* bias, void* out, int n_rows, int f,
                  int in_dtype, int out_dtype, int vec, int relu, void* stream) {
  if (n_rows <= 0 || f <= 0 || f % vec != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_vec<float, float>(vec, indptr, src, weight, x, bias, out, n_rows, f, relu, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, indptr, src, weight, x, bias, out,
                                                    n_rows, f, relu, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(vec, indptr, src, weight, x, bias, out, n_rows,
                                            f, relu, s);
  return cudaErrorInvalidValue;
}

const char* dgll_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
