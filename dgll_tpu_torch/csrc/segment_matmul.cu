// Weighted CSR SpMM (K1) with fused bias and ReLU, for Hopper (sm_90a).
//
//   out[r, :] = act(sum_{e in row r} w[e] * x[cols[e], :] + bias)
//
// with f32 accumulation, stored in the output type (f32, or bf16 for bf16 input).
//
// Replaces the TPU kernel dgll_tpu/ops/pallas/segment_matmul.py (_kernel, launched
// by spmm_chunked_pallas). That kernel packs edges into 512-slot chunks per 128-row
// block and turns each chunk into a one-hot [128, 512] x [512, F] matrix product,
// because the TPU has no atomics and runs its grid in order. This kernel computes
// the same function from a plain dst-major CSR instead.
//
// What bounds it: memory bytes. A call gathers E*F*itemsize bytes of source rows:
// from device memory where x does not fit the 50 MB L2, from L2 where sources
// repeat (the hub sources of a power-law graph, a clustered graph's communities,
// the contiguous messages of identity columns). It adds 8 bytes of column and
// weight per edge and writes n_rows*F*out_itemsize bytes.
//
// Design: work items of at most max_edges edges, one lane group each.
//
// * Rows of at most max_edges edges are one item each and write their output
//   directly. A longer row (a hub of a power-law graph: 53,866 in-edges on the CLI
//   graph) is cut into segments of max_edges edges by a schedule that depends only
//   on indptr (ops/chunked.py:split_schedule, built once per layout). Pass 1 writes
//   each segment's f32 partial row into a scratch buffer the caller allocates;
//   pass 2 (combine_kernel, one thread a column of a split row) adds a row's
//   partials in segment order, then the bias and ReLU. Both passes run on the
//   caller's stream in one C call. Segments come first in pass 1's grid, so the
//   hub work starts first and no row waits on one warp walking 50,000 edges.
// * A warp splits into groups of G lanes, G the power of two that covers the row's
//   F / VEC vector columns (at most 32; a wider row is tiled over gridDim.y). Each
//   lane keeps VEC consecutive columns as f32 sums in registers and reads them with
//   one load of up to 16 bytes. The 32 / G groups of a warp take interleaved edges
//   of the item (group g: edges g, g + 32/G, ...), so a narrow F (16 floats: 8
//   groups of 4 lanes) keeps the whole warp busy; the groups' sums are added by a
//   butterfly of shuffles in a fixed order at the item's end.
// * A group takes its edges kUnroll = 4 at a time: their columns and weights (each
//   lane loads them itself, the group's lanes the same words), then their rows,
//   while the next round's columns and weights are already being fetched. A warp
//   then has 4 row loads in flight at F = 128 in f32, 8 at F = 64, 32 at F = 16,
//   and more warps fit an SM than with 8 or 16 a group, which ran slower on the
//   card (more registers, fewer warps), as did reading a warp's columns 32 edges at
//   a time and shuffling them to the groups.
//
// There are no atomics, and every sum has a fixed order (edge order within a group,
// the shuffle tree across groups, segment order across segments): results are
// bitwise repeatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;        // row loads in flight per lane group
constexpr int kCombineThreads = 128;
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

// acc += sum of w[e] * x[cols[e], col:col+VEC] over e = first, first + step, ... < end,
// in that order.
template <typename TIn, int VEC>
__device__ __forceinline__ void sum_edges(const int* __restrict__ cols,
                                          const float* __restrict__ weight,
                                          const TIn* __restrict__ x, int first, int end,
                                          int step, int f, int col, bool active,
                                          float (&acc)[VEC]) {
  int s[kUnroll];
  float w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = first + u * step;
    s[u] = e < end ? __ldg(cols + e) : 0;
    w[u] = e < end ? __ldg(weight + e) : 0.f;
  }
  for (int base = first; base < end; base += kUnroll * step) {
    Pack<TIn, VEC> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (active && base + u * step < end)
        p[u] = *reinterpret_cast<const Pack<TIn, VEC>*>(x + (int64_t)s[u] * f + col);
    }
    // the next round's columns and weights, fetched while this round's rows arrive
    const int next = base + kUnroll * step;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (active && base + u * step < end) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = fmaf(w[u], to_float(p[u].v[k]), acc[k]);
      }
      const int e = next + u * step;
      s[u] = e < end ? __ldg(cols + e) : 0;
      w[u] = e < end ? __ldg(weight + e) : 0.f;
    }
  }
}

// Pass 1: one warp per work item. Items [0, n_seg) are the segments of the split
// rows, each summed into its f32 row of `partial`; items [n_seg, n_seg + n_rows) are
// the rows, of which those with more than max_edges edges are skipped (their
// segments cover them).
template <typename TIn, typename TOut, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                const float* __restrict__ weight, const TIn* __restrict__ x,
                const float* __restrict__ bias, TOut* __restrict__ out,
                const int* __restrict__ seg_beg, const int* __restrict__ seg_end,
                float* __restrict__ partial, int n_seg, int n_rows, int f, int log_g,
                int max_edges, int relu) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_seg + n_rows) return;  // the same for the whole warp
  const bool segment = item < n_seg;
  const int row = item - n_seg;
  int beg, end;
  if (segment) {
    beg = seg_beg[item];
    end = seg_end[item];
  } else {
    beg = indptr[row];
    end = indptr[row + 1];
    if (end - beg > max_edges) return;  // a split row
  }
  const int group = lane >> log_g;
  const int col = ((blockIdx.y << log_g) + (lane & ((1 << log_g) - 1))) * VEC;
  // F % VEC == 0, so a lane holds all VEC of its columns or none.
  const bool active = col < f;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  sum_edges<TIn, VEC>(cols, weight, x, beg + group, end, 32 >> log_g, f, col, active, acc);
  // the groups' sums, in a fixed tree order
  for (int off = 1 << log_g; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
  if (group != 0 || !active) return;

  if (segment) {
    Pack<float, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Pack<float, VEC>*>(partial + (int64_t)item * f + col) = o;
    return;
  }
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

// Pass 2: block x is split row x, a thread per column: the row's partials added in
// segment order, then the bias and ReLU.
template <typename TOut>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int* __restrict__ split_row, const int* __restrict__ split_ptr,
               const float* __restrict__ partial, const float* __restrict__ bias,
               TOut* __restrict__ out, int f, int relu) {
  const int c = blockIdx.y * kCombineThreads + threadIdx.x;
  if (c >= f) return;
  const int p1 = split_ptr[blockIdx.x + 1];
  float v = 0.f;
#pragma unroll 8
  for (int p = split_ptr[blockIdx.x]; p < p1; ++p) v += partial[(int64_t)p * f + c];
  if (bias != nullptr) v += bias[c];
  if (relu) v = fmaxf(v, 0.f);
  out[(int64_t)split_row[blockIdx.x] * f + c] = from_float<TOut>(v);
}

struct Schedule {
  const void* seg_beg;
  const void* seg_end;
  const void* split_row;
  const void* split_ptr;
  void* partial;
  int n_seg, n_split, max_edges;
};

template <typename TIn, typename TOut, int VEC>
cudaError_t launch(const void* indptr, const void* cols, const void* weight,
                   const void* x, const void* bias, void* out, int n_rows, int f,
                   int log_g, int relu, const Schedule& sc, cudaStream_t stream) {
  const int vec_cols = f / VEC;
  const dim3 grid((sc.n_seg + n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (vec_cols + (1 << log_g) - 1) >> log_g);
  spmm_csr_kernel<TIn, TOut, VEC><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(cols),
      static_cast<const float*>(weight), static_cast<const TIn*>(x),
      static_cast<const float*>(bias), static_cast<TOut*>(out),
      static_cast<const int*>(sc.seg_beg), static_cast<const int*>(sc.seg_end),
      static_cast<float*>(sc.partial), sc.n_seg, n_rows, f, log_g, sc.max_edges, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sc.n_split == 0) return err;
  const dim3 grid2(sc.n_split, (f + kCombineThreads - 1) / kCombineThreads);
  combine_kernel<TOut><<<grid2, kCombineThreads, 0, stream>>>(
      static_cast<const int*>(sc.split_row), static_cast<const int*>(sc.split_ptr),
      static_cast<const float*>(sc.partial), static_cast<const float*>(bias),
      static_cast<TOut*>(out), f, relu);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_vec(int vec, const void* indptr, const void* cols, const void* weight,
                       const void* x, const void* bias, void* out, int n_rows, int f,
                       int log_g, int relu, const Schedule& sc, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<TIn, TOut, 1>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                  relu, sc, stream);
    case 2:
      return launch<TIn, TOut, 2>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                  relu, sc, stream);
    case 4:
      return launch<TIn, TOut, 4>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                  relu, sc, stream);
    case 8:
      return launch<TIn, TOut, 8>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                  relu, sc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Supported (in, out) pairs: (0, 0),
// (1, 1), (1, 0). bias is float32 or null. vec (1, 2, 4 or 8) divides f; 2^log_g
// lanes (log_g in [0, 5]) take a row's f / vec vector columns. The schedule
// (ops/chunked.py:split_schedule): n_seg segments [seg_beg, seg_end) of the n_split
// rows split_row with more than max_edges edges, split_ptr their segment ranges;
// partial is float32 [n_seg, f] scratch (null when n_seg is 0). Launches pass 1 and,
// if a row is split, pass 2 on `stream`; returns cudaGetLastError() after them;
// nothing is launched when a check fails.
int dgll_spmm_csr(const void* indptr, const void* cols, const void* weight,
                  const void* x, const void* bias, void* out, int n_rows, int f,
                  int in_dtype, int out_dtype, int vec, int log_g, int relu,
                  const void* seg_beg, const void* seg_end, const void* split_row,
                  const void* split_ptr, void* partial, int n_seg, int n_split,
                  int max_edges, void* stream) {
  if (n_rows <= 0 || f <= 0 || vec <= 0 || f % vec != 0 || log_g < 0 || log_g > 5 ||
      n_seg < 0 || n_split < 0 || (n_seg > 0) != (n_split > 0) || max_edges <= 0 ||
      (n_seg > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Schedule sc{seg_beg, seg_end, split_row, split_ptr, partial, n_seg, n_split, max_edges};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_vec<float, float>(vec, indptr, cols, weight, x, bias, out, n_rows, f,
                                    log_g, relu, sc, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, indptr, cols, weight, x, bias, out,
                                                    n_rows, f, log_g, relu, sc, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(vec, indptr, cols, weight, x, bias, out, n_rows,
                                            f, log_g, relu, sc, s);
  return cudaErrorInvalidValue;
}

const char* dgll_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
