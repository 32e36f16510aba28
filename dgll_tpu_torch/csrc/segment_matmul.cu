// Weighted CSR SpMM (K1) with fused bias and ReLU, for Hopper (sm_90a).
//
//   out[r, :] = act(sum_{e in row r} w[e] * x[cols[e], :] + bias)
//
// with f32 accumulation, stored in the output type: f32 for f32 input (the float32
// route, dgll_spmm_csr), f32 or bf16 for bf16 input (the bfloat16 route further
// down, dgll_spmm_csr_bf16, with its own mapping).
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
// The float32 route's design: work items of at most max_edges edges, one lane group
// each.
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

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;        // row loads in flight per lane group
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }

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

cudaError_t launch_f32(int vec, const void* indptr, const void* cols, const void* weight,
                       const void* x, const void* bias, void* out, int n_rows, int f,
                       int log_g, int relu, const Schedule& sc, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<float, float, 1>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                     relu, sc, stream);
    case 2:
      return launch<float, float, 2>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                     relu, sc, stream);
    case 4:
      return launch<float, float, 4>(indptr, cols, weight, x, bias, out, n_rows, f, log_g,
                                     relu, sc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The bfloat16 route (bf16 input, f32 sums, bf16 or f32 output).
//
// What bounds it: the E * F * 2 bytes of messages, read once, and the output. At the
// GAT's narrow widths a row is short (a median of 17 edges, 32 bytes an edge at
// F = 16), so the float32 kernel's mapping (a warp a row, an edge a group, a
// butterfly of shuffles at the row's end, a column and a weight loaded for every edge
// before its message) spends more time on row overheads and dependent loads than on
// bytes. Here:
//
// * Work items come from a plan built once a layout from indptr alone
//   (ops/chunked.py:item_schedule): runs of whole consecutive rows (at most kItemRows
//   of them, their first edges within one window of the layout's edges), and the
//   segments of the split rows, which pass 2 adds as in the float32 route. A warp
//   takes an item.
// * The item's edges are one contiguous range, cut into 32 / G equal sub-ranges,
//   one for each group of G lanes (G covers F / VEC vector columns, as above). A
//   group walks its sub-range in order with kBfUnroll loads of up to 16 bytes in
//   flight a lane, and stores each row that begins and ends inside it as soon as it
//   ends. Rows are as balanced across the groups as edges are: a long row does not
//   hold up a warp of short ones. With identity columns a group reads its range of
//   messages in order, and each load asks L2 for the next 256 bytes.
// * On the card, 4 or 8 loads in flight a lane, 1 to 4 blocks an SM and windows of
//   128 to 2,048 edges were within 10-15% of each other; windows of 256 edges were
//   fastest; the L2 hint took 4-8% off identity columns and slowed gathers, which
//   do not take it. Launching pass 2 as pass 1's programmatic dependent saved no
//   measurable time.
// * A row that crosses sub-ranges leaves an f32 fragment in each group it crosses;
//   the group where it ends adds them in sub-range order, then its own part
//   (shared memory, one __syncwarp). A row's sum thus runs in edge order through at
//   most min(n, T) edges plus its segments, as in the float32 route.
// * Identity columns (cols == null: row r sums msg[indptr[r]:indptr[r+1]]) and unit
//   weights (weight == null) are compile-time cases: nothing is loaded for them, and
//   with identity columns a message load does not wait on a column load. Otherwise
//   the next round's columns and weights are fetched while this round's rows arrive.
// * bf16 pairs are widened from 32-bit words by shift and mask, which gives exactly
//   __bfloat162float's values; a unit weight adds (acc + x equals fmaf(1, x, acc)).
//
// Every sum has a fixed order: results are bitwise repeatable.
constexpr int kItemRows = 256;  // rows of an item at most (ops/chunked.py:ITEM_ROWS)
constexpr int kBfUnroll = 4;    // message loads in flight a lane

// VEC bfloat16 values as the raw bits one load moves.
template <int VEC>
struct RawOf;
template <>
struct RawOf<1> { using T = unsigned short; };
template <>
struct RawOf<2> { using T = unsigned int; };
template <>
struct RawOf<4> { using T = uint2; };
template <>
struct RawOf<8> { using T = uint4; };

// A load of a message of identity columns: the messages are read in order, so L2
// fetches the next 256 bytes with each (a gather wastes them: __ldg there).
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}
__device__ __forceinline__ uint2 ld_stream(const uint2* p) {
  uint2 r;
  asm("ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];" : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}
__device__ __forceinline__ unsigned ld_stream(const unsigned* p) {
  unsigned r;
  asm("ld.global.nc.L2::256B.u32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ unsigned short ld_stream(const unsigned short* p) {
  unsigned short r;
  asm("ld.global.nc.L2::256B.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return r;
}

template <int VEC>
__device__ __forceinline__ void widen(const typename RawOf<VEC>::T& r, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  } else {
    const unsigned* w = reinterpret_cast<const unsigned*>(&r);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// A finished sum: a segment's f32 partial row, or act(acc + bias) stored in TOut.
template <typename TOut, int VEC>
__device__ __forceinline__ void store_sum(const float (&acc)[VEC], bool segment, int64_t row,
                                          int f, int col, const float* __restrict__ bias,
                                          int relu, TOut* __restrict__ out,
                                          float* __restrict__ partial) {
  if (segment) {
    Pack<float, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Pack<float, VEC>*>(partial + row * f + col) = o;
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
  *reinterpret_cast<Pack<TOut, VEC>*>(out + row * f + col) = o;
}

// One warp an item: items [0, n_seg) are the split rows' segments (into `partial`),
// items [n_seg, n_seg + n_items) the plan's runs of whole rows.
// Blocks an SM at least: 4 (64 registers a thread) where only messages are loaded,
// else 2, which leaves the gathers' columns and weights room without spilling.
template <typename TOut, int VEC, bool kIdentity, bool kUnit>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kIdentity && kUnit ? 4 : 2)
spmm_bf16_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                 const float* __restrict__ weight, const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ bias, TOut* __restrict__ out,
                 const int* __restrict__ seg_beg, const int* __restrict__ seg_end,
                 float* __restrict__ partial, const int* __restrict__ item_beg,
                 const int* __restrict__ item_end, int n_seg, int n_items, int f,
                 int log_g, int relu) {
  using Raw = typename RawOf<VEC>::T;
  __shared__ int s_ptr[kWarpsPerBlock][kItemRows + 1];   // the item's row pointers
  __shared__ float s_frag[kWarpsPerBlock][32 * VEC];     // each lane's open fragment
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + warp;
  if (item >= n_seg + n_items) return;  // the same for the whole warp
  const bool segment = item < n_seg;
  int* ptr = s_ptr[warp];
  int r0 = item, n_local = 1;  // a segment is one row: its partial row `item`
  if (segment) {
    if (lane == 0) {
      ptr[0] = seg_beg[item];
      ptr[1] = seg_end[item];
    }
  } else {
    r0 = item_beg[item - n_seg];
    n_local = item_end[item - n_seg] - r0;
    for (int i = lane; i <= n_local; i += 32) ptr[i] = indptr[r0 + i];
  }
  __syncwarp();

  const int groups = 32 >> log_g, group = lane >> log_g;
  const int sub = lane & ((1 << log_g) - 1);
  const int col = ((blockIdx.y << log_g) + sub) * VEC;
  // F % VEC == 0, so a lane holds all VEC of its columns or none.
  const bool active = col < f;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  if (!segment && active) {  // rows without edges: act(bias)
    for (int i = group; i < n_local; i += groups)
      if (ptr[i] == ptr[i + 1])
        store_sum<TOut, VEC>(acc, false, r0 + i, f, col, bias, relu, out, partial);
  }

  // this group's sub-range [s0, s1) of the item's edges, and the row of its first edge
  const int e0 = ptr[0], e1 = ptr[n_local];
  const int span = (e1 - e0 + groups - 1) / groups;
  const int s0 = min(e0 + group * span, e1), s1 = min(s0 + span, e1);
  int i = 0;
  if (s0 < s1) {
    for (int hi = n_local; hi - i > 1;) {  // ptr[i] <= s0 < ptr[hi]
      const int mid = (i + hi) >> 1;
      if (ptr[mid] <= s0) i = mid; else hi = mid;
    }
  }
  bool open = s0 < s1 && ptr[i] < s0;  // row i began in an earlier sub-range
  int next_end = ptr[i + 1];
  int head_row = -1;                   // the row that began earlier and ended here
  float head[VEC];

  int src[kBfUnroll];
  float w[kBfUnroll];
#pragma unroll
  for (int u = 0; u < kBfUnroll; ++u) {
    const int e = s0 + u;
    src[u] = kIdentity ? e : (e < s1 ? __ldg(cols + e) : 0);
    w[u] = kUnit ? 1.f : (e < s1 ? __ldg(weight + e) : 0.f);
  }
  for (int base = s0; base < s1; base += kBfUnroll) {
    Raw p[kBfUnroll];
#pragma unroll
    for (int u = 0; u < kBfUnroll; ++u) {
      if (active && base + u < s1) {
        const Raw* at = reinterpret_cast<const Raw*>(x + (int64_t)src[u] * f + col);
        p[u] = kIdentity ? ld_stream(at) : __ldg(at);
      }
    }
#pragma unroll
    for (int u = 0; u < kBfUnroll; ++u) {
      const int e = base + u;
      if (e < s1) {
        if (active) {
          float v[VEC];
          widen<VEC>(p[u], v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = kUnit ? acc[k] + v[k] : fmaf(w[u], v[k], acc[k]);
        }
        if (e + 1 == next_end) {  // row i ends here
          if (open) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) head[k] = acc[k];
            head_row = i;
            open = false;
          } else if (active) {
            store_sum<TOut, VEC>(acc, segment, r0 + i, f, col, bias, relu, out, partial);
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
          for (++i; i < n_local && ptr[i + 1] == ptr[i]; ++i) {}  // skip rows without edges
          next_end = i < n_local ? ptr[i + 1] : INT_MAX;
        }
      }
      // the next round's columns and weights, fetched while this round's rows arrive
      const int en = e + kBfUnroll;
      src[u] = kIdentity ? en : (en < s1 ? __ldg(cols + en) : 0);
      w[u] = kUnit ? 1.f : (en < s1 ? __ldg(weight + en) : 0.f);
    }
  }

  // a row still open at s1 leaves its fragment; the group where it ends adds the
  // fragments of the sub-ranges it crossed, in order, then its own part
  float* frag = s_frag[warp];
  if (s0 < s1 && i < n_local && ptr[i] < s1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) frag[lane * VEC + k] = acc[k];
  }
  __syncwarp();
  if (head_row >= 0 && active) {
    float sum[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
    for (int q = (ptr[head_row] - e0) / span; q < group; ++q) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum[k] += frag[((q << log_g) + sub) * VEC + k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum[k] += head[k];
    store_sum<TOut, VEC>(sum, segment, r0 + head_row, f, col, bias, relu, out, partial);
  }
}

struct Bf16Args {
  const void *indptr, *cols, *weight, *x, *bias;
  void* out;
  const void *item_beg, *item_end;
  int n_items, f, log_g, relu;
};

template <typename TOut, int VEC, bool kIdentity, bool kUnit>
cudaError_t launch_bf16(const Bf16Args& a, const Schedule& sc, cudaStream_t stream) {
  const int vec_cols = a.f / VEC;
  const dim3 grid((sc.n_seg + a.n_items + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (vec_cols + (1 << a.log_g) - 1) >> a.log_g);
  spmm_bf16_kernel<TOut, VEC, kIdentity, kUnit><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int*>(a.indptr), static_cast<const int*>(a.cols),
      static_cast<const float*>(a.weight), static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const float*>(a.bias), static_cast<TOut*>(a.out),
      static_cast<const int*>(sc.seg_beg), static_cast<const int*>(sc.seg_end),
      static_cast<float*>(sc.partial), static_cast<const int*>(a.item_beg),
      static_cast<const int*>(a.item_end), sc.n_seg, a.n_items, a.f, a.log_g, a.relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sc.n_split == 0) return err;
  const dim3 grid2(sc.n_split, (a.f + kCombineThreads - 1) / kCombineThreads);
  combine_kernel<TOut><<<grid2, kCombineThreads, 0, stream>>>(
      static_cast<const int*>(sc.split_row), static_cast<const int*>(sc.split_ptr),
      static_cast<const float*>(sc.partial), static_cast<const float*>(a.bias),
      static_cast<TOut*>(a.out), a.f, a.relu);
  return cudaGetLastError();
}

template <typename TOut, bool kIdentity, bool kUnit>
cudaError_t launch_bf16_vec(int vec, const Bf16Args& a, const Schedule& sc,
                            cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_bf16<TOut, 1, kIdentity, kUnit>(a, sc, stream);
    case 2: return launch_bf16<TOut, 2, kIdentity, kUnit>(a, sc, stream);
    case 4: return launch_bf16<TOut, 4, kIdentity, kUnit>(a, sc, stream);
    case 8: return launch_bf16<TOut, 8, kIdentity, kUnit>(a, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TOut>
cudaError_t launch_bf16_kind(int vec, const Bf16Args& a, const Schedule& sc,
                             cudaStream_t stream) {
  const bool identity = a.cols == nullptr, unit = a.weight == nullptr;
  if (identity && unit) return launch_bf16_vec<TOut, true, true>(vec, a, sc, stream);
  if (identity) return launch_bf16_vec<TOut, true, false>(vec, a, sc, stream);
  if (unit) return launch_bf16_vec<TOut, false, true>(vec, a, sc, stream);
  return launch_bf16_vec<TOut, false, false>(vec, a, sc, stream);
}

}  // namespace

extern "C" {

// float32 input and output. bias is float32 or null. vec (1, 2 or 4) divides f;
// 2^log_g lanes (log_g in [0, 5]) take a row's f / vec vector columns. The schedule
// (ops/chunked.py:split_schedule): n_seg segments [seg_beg, seg_end) of the n_split
// rows split_row with more than max_edges edges, split_ptr their segment ranges;
// partial is float32 [n_seg, f] scratch (null when n_seg is 0). Launches pass 1 and,
// if a row is split, pass 2 on `stream`; returns cudaGetLastError() after them;
// nothing is launched when a check fails.
int dgll_spmm_csr(const void* indptr, const void* cols, const void* weight,
                  const void* x, const void* bias, void* out, int n_rows, int f, int vec,
                  int log_g, int relu, const void* seg_beg, const void* seg_end,
                  const void* split_row, const void* split_ptr, void* partial, int n_seg,
                  int n_split, int max_edges, void* stream) {
  if (n_rows <= 0 || f <= 0 || vec <= 0 || f % vec != 0 || log_g < 0 || log_g > 5 ||
      n_seg < 0 || n_split < 0 || (n_seg > 0) != (n_split > 0) || max_edges <= 0 ||
      (n_seg > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Schedule sc{seg_beg, seg_end, split_row, split_ptr, partial, n_seg, n_split, max_edges};
  return launch_f32(vec, indptr, cols, weight, x, bias, out, n_rows, f, log_g, relu, sc,
                    static_cast<cudaStream_t>(stream));
}

// bfloat16 input x, output float32 (out_dtype 0) or bfloat16 (1), the bfloat16 route
// above. cols null: identity columns; weight null: unit weights. vec (1, 2, 4 or 8)
// divides f; log_g as above. The split schedule as above (max_edges is the plan's),
// and the plan (ops/chunked.py:item_schedule): n_items runs of rows [item_beg,
// item_end), each of at most item_rows <= kItemRows rows, which with the split rows
// cover every output row once. Launches pass 1 and, if a row is split, pass 2 on
// `stream`; returns cudaGetLastError() after them; nothing is launched when a check
// fails.
int dgll_spmm_csr_bf16(const void* indptr, const void* cols, const void* weight,
                       const void* x, const void* bias, void* out, int f, int out_dtype,
                       int vec, int log_g, int relu, const void* seg_beg,
                       const void* seg_end, const void* split_row, const void* split_ptr,
                       void* partial, int n_seg, int n_split, const void* item_beg,
                       const void* item_end, int n_items, int item_rows, void* stream) {
  if (f <= 0 || vec <= 0 || f % vec != 0 || log_g < 0 || log_g > 5 || n_seg < 0 ||
      n_split < 0 || (n_seg > 0) != (n_split > 0) || (n_seg > 0 && partial == nullptr) ||
      n_items < 0 || n_seg + n_items <= 0 || item_rows <= 0 || item_rows > kItemRows)
    return cudaErrorInvalidValue;
  // max_edges is the float32 kernel's; this route's items carry no row above it
  const Schedule sc{seg_beg, seg_end, split_row, split_ptr, partial, n_seg, n_split, 0};
  const Bf16Args a{indptr, cols, weight, x, bias, out, item_beg, item_end, n_items, f,
                   log_g, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch_bf16_kind<__nv_bfloat16>(vec, a, sc, s);
  if (out_dtype == 0) return launch_bf16_kind<float>(vec, a, sc, s);
  return cudaErrorInvalidValue;
}

const char* dgll_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
