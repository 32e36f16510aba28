// Windowed SpMM (K2) with fused bias and ReLU, for Hopper (sm_90a).
//
//   out[r, :] = act(sum_{windowed edges e into row r} w[e] * x[src[e], :] + bias)
//
// with f32 accumulation, stored in the output type (f32, or bf16 for bf16 input).
//
// Replaces the TPU kernel dgll_tpu/ops/pallas/spmm_windowed.py (_kernel, launched by
// spmm_windowed_pallas). That kernel streams a 512-row window of x per chunk into
// VMEM and rebuilds each 128-edge sub-chunk's messages with one-hot matrix products
// (S_k @ GT_k^T, then T @ xsub), because a TPU gathers rows slowly and has no
// atomics. This kernel computes the same function over the port's own layout
// (dgll_tpu_torch/ops/windowed.py): edges in (row block, sub-chunk, destination,
// source) order; per sub-chunk its edge range, first staged row of x and row count
// (at most 128); per destination 128-row block its range of sub-chunks.
//
// Design: one block of 8 warps per (destination 128-row block, column tile of
// 32*VEC columns). It walks its row block's sub-chunks in order. For each one it
// stages the sub-chunk's rows of x (at most 128) for its column tile in shared
// memory, with coalesced VEC-wide loads (one warp per row), and the sub-chunk's
// edges (local source, local destination, weight). Warp w owns destination rows
// [16w, 16w+16) of the block: a ballot over the sub-chunk's sorted destinations
// finds its edge range, each lane keeps VEC columns of a running f32 sum per row
// and adds it into the block's accumulator in shared memory when the row changes.
// Each accumulator element is owned by one lane, so there are no atomics and the
// sum order is fixed (sub-chunk order, then source order): results are bitwise
// repeatable. The epilogue adds the bias, applies ReLU and stores every row of the
// block, so a block without windowed edges writes act(bias) or zeros.
//
// What bounds it: bytes of x staged. A sub-chunk stages up to its largest source,
// so a call reads about sum(rows staged) * F * itemsize bytes (rows of neighbouring
// sub-chunks of one window come from L2), 12 bytes per edge of metadata, and writes
// n_rows * F * out_itemsize bytes. The staging and the edge loop are not yet
// overlapped within a block (no cp.async double buffering); the three blocks an SM
// holds overlap each other's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBlock = 128;                    // destination rows per block
constexpr int kSub = 128;                         // edges per sub-chunk, at most
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kRowBlock / kWarps;  // destination rows a warp owns
constexpr unsigned kFull = 0xffffffffu;

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

template <typename TIn, int VEC>
constexpr size_t smem_bytes() {
  return size_t(kRowBlock) * 32 * VEC * (sizeof(float) + sizeof(TIn));
}

template <typename TIn, typename TOut, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
spmm_windowed_kernel(const int* __restrict__ blk_ptr, const int* __restrict__ sub_ptr,
                     const int* __restrict__ sub_x0, const int* __restrict__ sub_nx,
                     const int* __restrict__ src, const int* __restrict__ rows,
                     const float* __restrict__ weight, const TIn* __restrict__ x,
                     const float* __restrict__ bias, TOut* __restrict__ out, int f,
                     int relu) {
  constexpr int kTile = 32 * VEC;  // columns per block
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                // [kRowBlock][kTile]
  TIn* xs = reinterpret_cast<TIn*>(acc + kRowBlock * kTile);  // [kSub][kTile]
  __shared__ int s_src[kSub];    // source row within the staged rows
  __shared__ int s_dst[kSub];    // destination row within the block
  __shared__ float s_w[kSub];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int tcol = lane * VEC;                   // column within the tile
  const int col = blockIdx.y * kTile + tcol;     // column of x and out
  // F % VEC == 0, so a lane holds all VEC of its columns or none.
  const bool active = col < f;
  const int r_lo = warp * kRowsPerWarp;
  const int r_hi = r_lo + kRowsPerWarp;

  // Only this lane ever touches its accumulator elements: no barrier needed.
  Pack<float, VEC> zero;
#pragma unroll
  for (int k = 0; k < VEC; ++k) zero.v[k] = 0.f;
  for (int r = r_lo; r < r_hi; ++r)
    *reinterpret_cast<Pack<float, VEC>*>(acc + r * kTile + tcol) = zero;

  const int s_end = blk_ptr[blockIdx.x + 1];
  for (int s = blk_ptr[blockIdx.x]; s < s_end; ++s) {
    const int e0 = sub_ptr[s];
    const int ne = sub_ptr[s + 1] - e0;
    const int x0 = sub_x0[s];
    const int nx = sub_nx[s];
    __syncthreads();  // every warp is done with the previous sub-chunk's tiles
    if (threadIdx.x < ne) {
      s_src[threadIdx.x] = src[e0 + threadIdx.x] - x0;
      s_dst[threadIdx.x] = rows[e0 + threadIdx.x] - row0;
      s_w[threadIdx.x] = weight[e0 + threadIdx.x];
    }
    if (active) {
#pragma unroll 4
      for (int r = warp; r < nx; r += kWarps) {
        *reinterpret_cast<Pack<TIn, VEC>*>(xs + r * kTile + tcol) =
            *reinterpret_cast<const Pack<TIn, VEC>*>(x + (int64_t)(x0 + r) * f + col);
      }
    }
    __syncthreads();

    // The edges are sorted by destination: this warp's run is [lo, hi).
    int lo = 0, hi = 0;
    for (int base = 0; base < ne; base += 32) {
      const int d = base + lane < ne ? s_dst[base + lane] : kRowBlock;
      lo += __popc(__ballot_sync(kFull, d < r_lo));
      hi += __popc(__ballot_sync(kFull, d < r_hi));
    }
    if (!active || lo == hi) continue;

    float run[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) run[k] = 0.f;
    int cur = s_dst[lo];
    for (int e = lo; e < hi; ++e) {
      const int d = s_dst[e];
      if (d != cur) {
        Pack<float, VEC>* a = reinterpret_cast<Pack<float, VEC>*>(acc + cur * kTile + tcol);
        Pack<float, VEC> v = *a;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          v.v[k] += run[k];
          run[k] = 0.f;
        }
        *a = v;
        cur = d;
      }
      const Pack<TIn, VEC> p =
          *reinterpret_cast<const Pack<TIn, VEC>*>(xs + s_src[e] * kTile + tcol);
      const float w = s_w[e];
#pragma unroll
      for (int k = 0; k < VEC; ++k) run[k] = fmaf(w, to_float(p.v[k]), run[k]);
    }
    Pack<float, VEC>* a = reinterpret_cast<Pack<float, VEC>*>(acc + cur * kTile + tcol);
    Pack<float, VEC> v = *a;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v.v[k] += run[k];
    *a = v;
  }
  if (!active) return;

  for (int r = r_lo; r < r_hi; ++r) {
    const Pack<float, VEC> v = *reinterpret_cast<const Pack<float, VEC>*>(acc + r * kTile + tcol);
    Pack<TOut, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float y = v.v[k];
      if (bias != nullptr) y += bias[col + k];
      if (relu) y = fmaxf(y, 0.f);
      o.v[k] = from_float<TOut>(y);
    }
    *reinterpret_cast<Pack<TOut, VEC>*>(out + (int64_t)(row0 + r) * f + col) = o;
  }
}

template <typename TIn, typename TOut, int VEC>
cudaError_t launch(const void* blk_ptr, const void* sub_ptr, const void* sub_x0,
                   const void* sub_nx, const void* src, const void* rows,
                   const void* weight, const void* x, const void* bias, void* out,
                   int n_row_blocks, int f, int relu, cudaStream_t stream) {
  auto kernel = spmm_windowed_kernel<TIn, TOut, VEC>;
  constexpr size_t smem = smem_bytes<TIn, VEC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int cols = 32 * VEC;
  const dim3 grid(n_row_blocks, (f + cols - 1) / cols);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int*>(blk_ptr), static_cast<const int*>(sub_ptr),
      static_cast<const int*>(sub_x0), static_cast<const int*>(sub_nx),
      static_cast<const int*>(src), static_cast<const int*>(rows),
      static_cast<const float*>(weight), static_cast<const TIn*>(x),
      static_cast<const float*>(bias), static_cast<TOut*>(out), f, relu);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_vec(int vec, const void* blk_ptr, const void* sub_ptr,
                       const void* sub_x0, const void* sub_nx, const void* src,
                       const void* rows, const void* weight, const void* x,
                       const void* bias, void* out, int n_row_blocks, int f, int relu,
                       cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<TIn, TOut, 1>(blk_ptr, sub_ptr, sub_x0, sub_nx, src, rows, weight, x,
                                  bias, out, n_row_blocks, f, relu, stream);
    case 2:
      return launch<TIn, TOut, 2>(blk_ptr, sub_ptr, sub_x0, sub_nx, src, rows, weight, x,
                                  bias, out, n_row_blocks, f, relu, stream);
    case 4:
      return launch<TIn, TOut, 4>(blk_ptr, sub_ptr, sub_x0, sub_nx, src, rows, weight, x,
                                  bias, out, n_row_blocks, f, relu, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Supported (in, out) pairs: (0, 0),
// (1, 1), (1, 0). bias is float32 or null. vec is 1, 2 or 4 and divides f. Returns
// cudaGetLastError() after the launch; nothing is launched when a check fails.
int dgll_spmm_windowed(const void* blk_ptr, const void* sub_ptr, const void* sub_x0,
                       const void* sub_nx, const void* src, const void* rows,
                       const void* weight, const void* x, const void* bias, void* out,
                       int n_row_blocks, int f, int in_dtype, int out_dtype, int vec,
                       int relu, void* stream) {
  if (n_row_blocks <= 0 || f <= 0 || vec <= 0 || f % vec != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_vec<float, float>(vec, blk_ptr, sub_ptr, sub_x0, sub_nx, src, rows,
                                    weight, x, bias, out, n_row_blocks, f, relu, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, blk_ptr, sub_ptr, sub_x0, sub_nx,
                                                    src, rows, weight, x, bias, out,
                                                    n_row_blocks, f, relu, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(vec, blk_ptr, sub_ptr, sub_x0, sub_nx, src, rows,
                                            weight, x, bias, out, n_row_blocks, f, relu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
