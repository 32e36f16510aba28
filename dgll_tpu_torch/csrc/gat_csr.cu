// GAT attention kernels over the dst-major CSR, for Hopper (sm_90a).
//
// The kernels of the fused GAT layer (ops/cuda/gat_fused.py) and of the round-4
// attention path (ops/gat.py, ops/edge_ops.py), all float32. Per-edge arrays are
// [nnz, H] in the CSR's edge order (the edges of row r are indptr[r]..indptr[r+1]);
// per-row arrays are [n_rows, H].
//
//   K3 gat_stats:        m[r,h] = max_e e_{e,h},  den[r,h] = sum_e exp(e_{e,h} - m[r,h]),
//                        e = LeakyReLU(sc_src[e,h] + s_dst[r,h]); a row without edges
//                        gives m = -3e38 and den = 0.
//   K4 gat_alpha:        alpha[e,h] = exp(min(e - m[r,h], 0)) * (1 / max(den[r,h], 1e-16)),
//                        lgrad[e,h] = 1 if the score is positive, else the slope.
//   K5 gat_bwd_softmax:  dz[e,h] = alpha * (dalpha - S[r,h]) * lgrad,  dsd[r,h] = sum_e dz.
//   K6 edges_to_rows:    out[r,h] = sum_e v[e,h] (sum mode), or max_e v[e,h] with -3e38
//                        on a row without edges (max mode).
//   K7 expand_rows:      out[e,:] = a[r,:].
//   K9 sddmm:            out[e] = <a[r,:], msg[e,:]>.
//
// They replace the TPU kernels _stats_kernel, _alpha_kernel and _bwd_sm_kernel
// (dgll_tpu/ops/pallas/gat_fused.py), _e2r_multi_kernel (dgll_tpu/ops/pallas/
// edge_ops.py; its sum, sum_all and max modes), _expand_kernel
// (dgll_tpu/ops/pallas/expand_rows.py) and _sddmm_kernel (dgll_tpu/ops/pallas/
// sddmm.py). Those walk 128-row blocks of edge chunks in grid order, carry running
// sums from chunk to chunk in scratch memory, and move values between rows and edges
// with one-hot matrix products (the TPU has no gather or atomics). Here each row is
// one warp's, so nothing carries between blocks, and rows and edges meet through the
// CSR's indptr and row ids.
//
// Three more TPU kernels need no kernel of their own: _r2e_multi_kernel (K6') and
// the single-head _rows_to_edges_kernel (K10, edge_ops.py) compute what K7 computes
// at width H and at width 1, and the single-head _reduce_kernel (K10) computes what
// K6 computes at H = 1. Its sum_all mode, which also sums the TPU layout's padding
// slots, is the sum mode here: this layout has no padding slots. Their wrappers
// (ops/cuda/edge_ops.py) launch K7 and K6 and count the launches apart.
//
// Design. The row reductions (K3, K5, K6) give each destination row one warp, with
// the head loop inside: the lanes stride over the row's edges, and a shuffle
// reduction across the warp finishes each head. Every row's outputs are written,
// rows without edges included, and no atomics are used, so results are bitwise
// repeatable. K3 takes two passes per head, the max and then the sum of exponentials,
// so that m is exact and den is the JAX package's sum, not an online rescaling. K6
// is one kernel templated on its reduction; the max is exact. The per-edge passes
// (K4, K7) are grid-stride loops over the flat [nnz * H] or [nnz * F] index. K9 is
// per edge too: every edge's dot product is independent, so a group of a few lanes
// (a power of two, up to 32, no more than the row's float4 count) owns one edge,
// reads its msg row and a[r] (through the read-only cache: a is small and its rows
// repeat along a row's edges) in float4 units, and finishes with a shuffle
// reduction inside the group. Parallel over edges, it has no hub-row tail.
//
// What bounds them: memory bytes, a few float32 values per edge and head. K4, K7
// and K9 stream their per-edge arrays once. The row reductions read per-edge values
// with a stride of H floats per head pass, so for H > 1 each sector is fetched once
// and then found in L1/L2 by the next heads. A hub row is walked by one warp alone
// (the tail that K1, csrc/segment_matmul.cu, shows): on a power-law graph the
// largest in-degree sets a floor under K3, K5 and K6. Splitting hub rows is left
// for a later change.
//
// Precision: expf and IEEE division (no --use_fast_math, no __expf), as the JAX
// package's kernels need full float32 here (gat_fused.py:155-160).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;         // per block, for the grid-stride kernels
constexpr int kMaxStrideBlocks = 132 * 16;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_stats_kernel(const int* __restrict__ indptr, const float* __restrict__ sc_src,
                 const float* __restrict__ s_dst, float* __restrict__ m,
                 float* __restrict__ den, int n_rows, int heads, float slope) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the same for the whole warp
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int h = 0; h < heads; ++h) {
    const float sd = s_dst[(int64_t)row * heads + h];
    float mx = kNeg;
    for (int e = beg + lane; e < end; e += 32)
      mx = fmaxf(mx, leaky(sc_src[(int64_t)e * heads + h] + sd, slope));
    mx = warp_max(mx);
    float s = 0.f;
    for (int e = beg + lane; e < end; e += 32)
      s += expf(leaky(sc_src[(int64_t)e * heads + h] + sd, slope) - mx);
    s = warp_sum(s);
    if (lane == 0) {
      m[(int64_t)row * heads + h] = mx;
      den[(int64_t)row * heads + h] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gat_alpha_kernel(const int* __restrict__ rows, const float* __restrict__ sc_src,
                 const float* __restrict__ s_dst, const float* __restrict__ m,
                 const float* __restrict__ den, float* __restrict__ alpha,
                 float* __restrict__ lgrad, int64_t n, int heads, float slope) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / heads;
    const int64_t d = (int64_t)rows[e] * heads + (i - e * heads);
    const float z = sc_src[i] + s_dst[d];
    const float inv = 1.f / fmaxf(den[d], 1e-16f);
    alpha[i] = expf(fminf(leaky(z, slope) - m[d], 0.f)) * inv;
    lgrad[i] = z > 0.f ? 1.f : slope;
  }
}

// The reductions of K6: an identity, a combine, and the warp's shuffle reduction.
struct SumOp {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float b) { return a + b; }
  static __device__ __forceinline__ float warp(float v) { return warp_sum(v); }
};

struct MaxOp {
  static __device__ __forceinline__ float init() { return kNeg; }
  static __device__ __forceinline__ float combine(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float warp(float v) { return warp_max(v); }
};

template <typename Op>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edges_to_rows_kernel(const int* __restrict__ indptr, const float* __restrict__ v,
                     float* __restrict__ out, int n_rows, int heads) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int h = 0; h < heads; ++h) {
    float s = Op::init();
    for (int e = beg + lane; e < end; e += 32) s = Op::combine(s, v[(int64_t)e * heads + h]);
    s = Op::warp(s);
    if (lane == 0) out[(int64_t)row * heads + h] = s;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_softmax_kernel(const int* __restrict__ indptr, const float* __restrict__ alpha,
                       const float* __restrict__ dalpha, const float* __restrict__ lgrad,
                       const float* __restrict__ s_row, float* __restrict__ dz,
                       float* __restrict__ dsd, int n_rows, int heads) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int h = 0; h < heads; ++h) {
    const float sr = s_row[(int64_t)row * heads + h];
    float s = 0.f;
    for (int e = beg + lane; e < end; e += 32) {
      const int64_t i = (int64_t)e * heads + h;
      const float v = alpha[i] * (dalpha[i] - sr) * lgrad[i];
      dz[i] = v;
      s += v;
    }
    s = warp_sum(s);
    if (lane == 0) dsd[(int64_t)row * heads + h] = s;
  }
}

// T is float or float4: the wrapper passes fv = F / (sizeof(T) / 4) units per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int* __restrict__ rows, const T* __restrict__ a,
                   T* __restrict__ out, int64_t n, int fv) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / fv;
    out[i] = a[(int64_t)rows[e] * fv + (i - e * fv)];
  }
}

__device__ __forceinline__ float fma_dot(float x, float y, float s) { return fmaf(x, y, s); }

__device__ __forceinline__ float fma_dot(float4 x, float4 y, float s) {
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  return fmaf(x.w, y.w, s);
}

// T is float or float4: fv = F / (sizeof(T) / 4) units per row. A group of `lanes`
// lanes (a power of two, 32 at most, fv at least) owns one edge; the loop bound
// depends on the warp only, so every lane reaches every shuffle.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ rows, const T* __restrict__ a,
             const T* __restrict__ msg, float* __restrict__ out, int64_t nnz, int fv,
             int lanes) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = (((int64_t)gridDim.x * blockDim.x) >> 5) * per_warp;
  for (int64_t base = warp * per_warp; base < nnz; base += stride) {
    const int64_t e = base + lane / lanes;
    float s = 0.f;
    if (e < nnz) {
      const T* ar = a + (int64_t)__ldg(rows + e) * fv;
      const T* mr = msg + e * fv;
      for (int u = sub; u < fv; u += lanes) s = fma_dot(__ldg(ar + u), mr[u], s);
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (e < nnz && sub == 0) out[e] = s;
  }
}

int row_blocks(int n_rows) { return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock; }

int stride_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxStrideBlocks ? b : kMaxStrideBlocks);
}

template <typename Op>
int edges_to_rows(const void* indptr, const void* v, void* out, int n_rows, int heads,
                  void* stream) {
  if (n_rows <= 0 || heads <= 0) return cudaErrorInvalidValue;
  edges_to_rows_kernel<Op><<<row_blocks(n_rows), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const float*>(v),
      static_cast<float*>(out), n_rows, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch, or cudaErrorInvalidValue (and
// launches nothing) for a bad size. All pointers are float32 or int32 device memory.

int dgll_gat_stats(const void* indptr, const void* sc_src, const void* s_dst, void* m,
                   void* den, int n_rows, int heads, float slope, void* stream) {
  if (n_rows <= 0 || heads <= 0) return cudaErrorInvalidValue;
  gat_stats_kernel<<<row_blocks(n_rows), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const float*>(sc_src),
      static_cast<const float*>(s_dst), static_cast<float*>(m), static_cast<float*>(den),
      n_rows, heads, slope);
  return cudaGetLastError();
}

int dgll_gat_alpha(const void* rows, const void* sc_src, const void* s_dst, const void* m,
                   const void* den, void* alpha, void* lgrad, long long nnz, int heads,
                   float slope, void* stream) {
  if (nnz < 0 || heads <= 0) return cudaErrorInvalidValue;
  const int64_t n = (int64_t)nnz * heads;
  if (n == 0) return cudaSuccess;
  gat_alpha_kernel<<<stride_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const float*>(sc_src),
      static_cast<const float*>(s_dst), static_cast<const float*>(m),
      static_cast<const float*>(den), static_cast<float*>(alpha),
      static_cast<float*>(lgrad), n, heads, slope);
  return cudaGetLastError();
}

int dgll_edges_to_rows_sum(const void* indptr, const void* v, void* out, int n_rows,
                           int heads, void* stream) {
  return edges_to_rows<SumOp>(indptr, v, out, n_rows, heads, stream);
}

int dgll_edges_to_rows_max(const void* indptr, const void* v, void* out, int n_rows,
                           int heads, void* stream) {
  return edges_to_rows<MaxOp>(indptr, v, out, n_rows, heads, stream);
}

int dgll_gat_bwd_softmax(const void* indptr, const void* alpha, const void* dalpha,
                         const void* lgrad, const void* s_row, void* dz, void* dsd,
                         int n_rows, int heads, void* stream) {
  if (n_rows <= 0 || heads <= 0) return cudaErrorInvalidValue;
  gat_bwd_softmax_kernel<<<row_blocks(n_rows), kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const float*>(alpha),
      static_cast<const float*>(dalpha), static_cast<const float*>(lgrad),
      static_cast<const float*>(s_row), static_cast<float*>(dz), static_cast<float*>(dsd),
      n_rows, heads);
  return cudaGetLastError();
}

// vec = 4 moves float4 units (F % 4 == 0 and 16-byte aligned pointers), else 1.
int dgll_expand_rows(const void* rows, const void* a, void* out, long long nnz, int f,
                     int vec, void* stream) {
  if (nnz < 0 || f <= 0 || (vec != 1 && vec != 4) || f % vec != 0)
    return cudaErrorInvalidValue;
  const int fv = f / vec;
  const int64_t n = (int64_t)nnz * fv;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    expand_rows_kernel<float4><<<stride_blocks(n), kThreads, 0, s>>>(
        static_cast<const int*>(rows), static_cast<const float4*>(a),
        static_cast<float4*>(out), n, fv);
  else
    expand_rows_kernel<float><<<stride_blocks(n), kThreads, 0, s>>>(
        static_cast<const int*>(rows), static_cast<const float*>(a),
        static_cast<float*>(out), n, fv);
  return cudaGetLastError();
}

// vec = 4 moves float4 units (F % 4 == 0 and 16-byte aligned pointers), else 1;
// lanes per edge: a power of two, at most 32 and at most F / vec.
int dgll_sddmm(const void* rows, const void* a, const void* msg, void* out, long long nnz,
               int f, int vec, int lanes, void* stream) {
  if (nnz < 0 || f <= 0 || (vec != 1 && vec != 4) || f % vec != 0) return cudaErrorInvalidValue;
  const int fv = f / vec;
  if (lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 || lanes > fv)
    return cudaErrorInvalidValue;
  if (nnz == 0) return cudaSuccess;
  const int64_t warps = (nnz + 32 / lanes - 1) / (32 / lanes);
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(blocks < kMaxStrideBlocks ? blocks : kMaxStrideBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    sddmm_kernel<float4><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(rows), static_cast<const float4*>(a),
        static_cast<const float4*>(msg), static_cast<float*>(out), nnz, fv, lanes);
  else
    sddmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(rows), static_cast<const float*>(a),
        static_cast<const float*>(msg), static_cast<float*>(out), nnz, fv, lanes);
  return cudaGetLastError();
}

}  // extern "C"
