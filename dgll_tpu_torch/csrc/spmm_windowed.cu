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
// What bounds it: bytes of x staged. A sub-chunk stages up to its largest source,
// so a call reads about sum(rows staged) * F * itemsize bytes (rows of neighbouring
// sub-chunks of one window come from L2), 12 bytes per edge of metadata, and writes
// n_rows * F * out_itemsize bytes.
//
// Design: one block of 16 warps per (destination 128-row block, column tile of
// 32*VEC columns; VEC <= 4, so F = 128 is one tile in f32 and bf16). The block walks
// its row block's sub-chunks through a ring of kStages = 3 stages in shared memory
// (64 KB of rows each for a 128-column f32 tile): while the warps sum sub-chunk k,
// the copies of sub-chunks k+1 and k+2 are in flight. Each thread issues cp.async
// copies (16 bytes where VEC allows; warp w the rows w, w + 16, ..., a lane a
// VEC-wide piece of each) of the sub-chunk's rows of x for the tile and of its
// edges (source, destination, weight), one commit group a sub-chunk. A wait on the
// group then a barrier make a stage visible and tell that the stage summed last is
// free, which the step refills at once. (cp.async writes through the generic proxy,
// so no proxy fence is needed before a stage is reused, unlike cp.async.bulk.)
// Warp w owns destination rows [8w, 8w+8) of the block and keeps their sums in
// registers (8 rows x VEC columns a lane), not in shared memory: a ballot over the
// sub-chunk's sorted destinations finds its edge range, and a loop unrolled over its
// 8 rows adds each edge into its row's registers. Each sum is owned by one lane and
// taken in a fixed order (sub-chunk order, then source order): no atomics, and
// results are bitwise repeatable. The epilogue adds the bias, applies ReLU and stores
// every row of the block, so a block without windowed edges writes act(bias) or
// zeros. Measured on the card and not kept: issuing the next copies before the
// wait (a second barrier a step), loading the metadata one issue ahead, up to 8
// stages for narrow tiles, and a warp's edges batched in registers (4 rows loaded
// at a time, each added to its row under a predicate): each was slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBlock = 128;                    // destination rows per block
constexpr int kSub = 128;                         // edges per sub-chunk, at most
constexpr int kWarps = 16;
constexpr int kRowsPerWarp = kRowBlock / kWarps;  // destination rows a warp owns
constexpr int kStages = 3;                        // sub-chunks staged at a time
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from global to shared memory: asynchronously for 4, 8 or 16 bytes (16 bypasses
// L1), a plain copy for 2 (which the barrier after the stage's wait publishes too).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if constexpr (BYTES >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One stage: the sub-chunk's staged rows of x for the tile, then its edges.
template <typename TIn, int VEC>
struct StageLayout {
  static constexpr int kTile = 32 * VEC;  // columns per block
  static constexpr int kXBytes = kSub * kTile * sizeof(TIn);
  static constexpr int kBytes = kXBytes + 3 * kSub * 4;
};

template <typename TIn, typename TOut, int VEC>
__global__ void __launch_bounds__(kWarps * 32, 1)
spmm_windowed_kernel(const int* __restrict__ blk_ptr, const int* __restrict__ sub_ptr,
                     const int* __restrict__ sub_x0, const int* __restrict__ sub_nx,
                     const int* __restrict__ src, const int* __restrict__ rows,
                     const float* __restrict__ weight, const TIn* __restrict__ x,
                     const float* __restrict__ bias, TOut* __restrict__ out, int f,
                     int relu) {
  using L = StageLayout<TIn, VEC>;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_meta[kStages][2];  // per stage: edge count, first staged row of x

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowBlock;
  const int col0 = blockIdx.y * kTile;
  const int tcol = lane * VEC;  // column within the tile
  // F % VEC == 0, so a lane holds all VEC of its columns or none.
  const bool active = col0 + tcol < f;
  const int s_beg = blk_ptr[blockIdx.x];
  const int n_sub = blk_ptr[blockIdx.x + 1] - s_beg;

  // the copies of sub-chunk k, if the block has it, then one commit group
  auto issue = [&](int k) {
    if (k < n_sub) {
      const int s = s_beg + k;
      const int e0 = sub_ptr[s];
      const int ne = sub_ptr[s + 1] - e0;
      const int x0 = sub_x0[s];
      const int nx = sub_nx[s];
      unsigned char* st = smem + (k % kStages) * L::kBytes;
      TIn* xs = reinterpret_cast<TIn*>(st);
      int* e_src = reinterpret_cast<int*>(st + L::kXBytes);
      // warp w copies rows w, w + kWarps, ...: lane l the row's l-th VEC-wide piece
      if (active) {
        for (int r = warp; r < nx; r += kWarps)
          copy_async<int(VEC * sizeof(TIn))>(xs + r * kTile + tcol,
                                             x + (int64_t)(x0 + r) * f + col0 + tcol);
      }
      if (tid < ne) {
        copy_async<4>(e_src + tid, src + e0 + tid);
        copy_async<4>(e_src + kSub + tid, rows + e0 + tid);
        copy_async<4>(e_src + 2 * kSub + tid, weight + e0 + tid);
      }
      if (tid == 0) {
        s_meta[k % kStages][0] = ne;
        s_meta[k % kStages][1] = x0;
      }
    }
    commit_group();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float acc[kRowsPerWarp][VEC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[r][k] = 0.f;
  }
  const int d_lo = row0 + warp * kRowsPerWarp;  // this warp's first destination row

  for (int k = 0; k < n_sub; ++k) {
    wait_group<kStages - 2>();  // this thread's copies of sub-chunk k have landed
    __syncthreads();            // everyone's have, and sub-chunk k-1 is summed
    issue(k + kStages - 1);     // into the stage sub-chunk k-1 used

    const int st_i = k % kStages;
    const unsigned char* st = smem + st_i * L::kBytes;
    const TIn* xs = reinterpret_cast<const TIn*>(st);
    const int* e_src = reinterpret_cast<const int*>(st + L::kXBytes);
    const int* e_dst = e_src + kSub;
    const float* e_w = reinterpret_cast<const float*>(e_src + 2 * kSub);
    const int ne = s_meta[st_i][0];
    const int x0 = s_meta[st_i][1];

    // The edges are sorted by destination: this warp's run is [lo, hi).
    int lo = 0, hi = 0;
    for (int base = 0; base < ne; base += 32) {
      const int d = base + lane < ne ? e_dst[base + lane] : row0 + kRowBlock;
      lo += __popc(__ballot_sync(kFull, d < d_lo));
      hi += __popc(__ballot_sync(kFull, d < d_lo + kRowsPerWarp));
    }
    if (!active) continue;
    int e = lo;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      for (; e < hi && e_dst[e] == d_lo + r; ++e) {
        const Pack<TIn, VEC> p =
            *reinterpret_cast<const Pack<TIn, VEC>*>(xs + (e_src[e] - x0) * kTile + tcol);
        const float w = e_w[e];
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[r][c] = fmaf(w, to_float(p.v[c]), acc[r][c]);
      }
    }
  }
  if (!active) return;

  const int col = col0 + tcol;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    Pack<TOut, VEC> o;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float y = acc[r][c];
      if (bias != nullptr) y += bias[col + c];
      if (relu) y = fmaxf(y, 0.f);
      o.v[c] = from_float<TOut>(y);
    }
    *reinterpret_cast<Pack<TOut, VEC>*>(out + (int64_t)(d_lo + r) * f + col) = o;
  }
}

template <typename TIn, typename TOut, int VEC>
cudaError_t launch(const void* blk_ptr, const void* sub_ptr, const void* sub_x0,
                   const void* sub_nx, const void* src, const void* rows,
                   const void* weight, const void* x, const void* bias, void* out,
                   int n_row_blocks, int f, int relu, cudaStream_t stream) {
  auto kernel = spmm_windowed_kernel<TIn, TOut, VEC>;
  constexpr int smem = kStages * StageLayout<TIn, VEC>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
// (1, 1), (1, 0). bias is float32 or null. vec is 1, 2 or 4 and divides f; x is
// aligned to vec elements. Returns cudaGetLastError() after the launch; nothing is
// launched when a check fails.
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
