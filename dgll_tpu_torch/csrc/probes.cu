// The primitive probes P0, P2, P2b, P3 and P4, for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels of benchmarks/pallas_probe_r4.py, the probe that
// measured, on the TPU, each primitive a gather-fused SpMM could be built from. Each
// kernel computes the probe's function; none copies its TPU block structure:
//
//   P0   out = x                          _copy_kernel    (:53, pallas_call :60)
//   P2   out[e] = win[idx[e]]             _dynread_kernel (:72, pallas_call :87)
//   P2b  out = onehot(idx) @ win          _onehot_kernel  (:102, pallas_call :111)
//   P3   acc = 0; acc[idx[e]] += msg[e]   _dynacc_kernel  (:126, pallas_call :151)
//   P4   out[e] = x[idx[e]]               _dma_kernel     (:171, pallas_call :199)
//
// idx is the flat [E] int32 array (the probe's [E / 512, 512] chunks, row-major).
// Every row is F float32 values, F % 4 == 0, so a row is a run of 16-byte vectors and
// a lane moves 16 bytes at a time. An index must lie in its table: P2, P3 and P4 read
// or write out of bounds otherwise (the callers draw them in range, as the TPU probe
// does); P2b gives a zero row, as the one-hot product does.
//
// What bounds them on this card: bytes, except P2b. P0 reads and writes each byte
// once (the achieved-bandwidth calibration). P2 and P2b read the window once a block
// and write E rows; P4 reads E rows anywhere in x and writes them; P3 reads E rows and
// adds them into a 4 MiB accumulator that stays in the 50 MB L2. P2b is a dense
// product of E x WIN x F multiply-adds, twice (see below), on the tensor cores.
//
// Designs, against what the TPU kernels did:
//
// * P0: a float4 copy, one vector a thread over a grid that covers the array (a
//   grid-stride loop only past 2^31 blocks): on the H100 this streamed faster than a
//   grid of a few blocks an SM looping, with or without four loads in flight.
// * P2: the TPU fetched the window once because its block index is constant. Here a
//   persistent grid (one block per SM) stages the window in dynamic shared memory once
//   a block, then each warp takes 32 consecutive rows: lane l loads idx of row l, the
//   warp broadcasts each index with a shuffle and copies that window row, one float4
//   a lane (32 lanes x 16 bytes is one 128-float row).
// * P2b: the one-hot product on the tensor cores, mma.sync.m16n8k8 at TF32 with f32
//   accumulation. TF32 keeps 10 bits of mantissa, so win is split as win = hi + lo,
//   each rounded to TF32, and the product is G @ hi + G @ lo: G is 0 or 1 (exact in
//   TF32) and each output row has one nonzero term, so the result is hi + lo, within
//   about 2^-21 of win. The window is staged once a block as float32 (rows padded by 8
//   floats, so that a B fragment's 32 loads hit 32 banks) and split as each B fragment
//   is loaded. G never exists in memory: each lane holds the window rows of its
//   fragment rows and builds its A fragment (1.0 where the row's index equals the
//   column, else 0) in registers at every K step. A warp takes 64 rows (4 M tiles)
//   and 32 columns (4 N tiles) at a time, so each B fragment, split once, feeds 8
//   products.
// * P3: the TPU carried the accumulator in VMEM through a sequential grid. Blocks here
//   run concurrently, so the rows are scattered through L2 with atomicAdd whose result
//   is unused (RED.ADD.F32), one warp a message row, 32 consecutive floats a
//   instruction. This is the form the hub-row split of the SpMM kernel would use. The
//   accumulator is zeroed by the same call (cudaMemsetAsync), as the TPU kernel zeroes
//   it at grid step 0. The f32 sums depend on the order of the atomics: not bitwise
//   repeatable.
// * P4: the TPU's per-row DMA ring (DEPTH copies in flight, rows in id order) is not
//   carried over. At the probe's size the table (256 MB) is five times the card's L2
//   and the ids draw each row about 8 times, so in id order most reads miss L2. The
//   bucketed path reads the table one slice at a time: a bucket pass (three small
//   kernels) sorts the positions by the bucket of their row (2^shift rows, a few MB of
//   table), and the gather walks them in that order with few warps resident (the
//   positions in flight cover about one bucket) and many loads in flight a warp, so a
//   row's repeated draws hit L2 and the table comes from memory about once. Its writes
//   land at scattered rows, whole 128-byte lines each. The direct path, the same
//   gather in id order, serves tables that L2 holds and ids that draw a row too few
//   times to pay for the bucket pass; the plan is the wrapper's (ops/probes.py:
//   p4_plan). Both write each output row once, so both are exact and deterministic
//   whatever order the bucket pass leaves inside a bucket.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kWarpRows = 32;       // rows a warp takes at once (one index a lane)
constexpr int kDynreadThreads = 1024;
constexpr int kScatterThreads = 256;
constexpr int kOnehotWarps = 8;
constexpr int kMTiles = 4;          // P2b: 16-row M tiles a warp takes at once
constexpr int kNTiles = 4;          // P2b: 8-column N tiles a warp takes at once
constexpr int kWinPad = 8;          // P2b: floats of padding after each window row
constexpr int kGatherThreads = 256; // P4's gather: threads a block, at most
constexpr int kBucketThreads = 512;
constexpr int kSpanItems = 8;       // P4: positions a thread of the bucket pass takes
constexpr int kSpan = kBucketThreads * kSpanItems;   // positions a block of it takes
constexpr int kMaxBuckets = 8192;   // P4: counters of the bucket pass
constexpr int kScanThreads = 1024;

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int max_dynamic_smem() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return n;
}

// ------------------------------------------------------------------- P0: copy
__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ x, float4* __restrict__ out, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = __ldg(x + i);
  }
}

// ------------------------------------------------------- P2: window gather
__global__ void __launch_bounds__(kDynreadThreads)
dynread_kernel(const int* __restrict__ idx, const float* __restrict__ win,
               float* __restrict__ out, int64_t e, int win_rows, int f) {
  extern __shared__ __align__(16) float win_s[];
  const int f4 = f / 4;
  const float4* win4 = reinterpret_cast<const float4*>(win);
  float4* win_s4 = reinterpret_cast<float4*>(win_s);
  for (int i = threadIdx.x; i < win_rows * f4; i += blockDim.x) win_s4[i] = __ldg(win4 + i);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t groups = (e + kWarpRows - 1) / kWarpRows;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t g = warp; g < groups; g += warps) {
    const int64_t base = g * kWarpRows;
    const int rows = static_cast<int>(e - base < kWarpRows ? e - base : kWarpRows);
    const int mine = lane < rows ? __ldg(idx + base + lane) : 0;
    for (int j = 0; j < rows; ++j) {
      const int r = __shfl_sync(0xffffffffu, mine, j);
      float4* dst = reinterpret_cast<float4*>(out + (base + j) * f);
      for (int c = lane; c < f4; c += 32) dst[c] = win_s4[r * f4 + c];
    }
  }
}

// ---------------------------------------------------- P2b: one-hot product
// TF32 by rounding to nearest (ties away from zero) the 13 low bits of the mantissa
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// c += a @ b: a 16 x 8 TF32 A fragment, an 8 x 8 B fragment, a 16 x 8 f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kOnehotWarps * 32)
onehot_kernel(const int* __restrict__ idx, const float* __restrict__ win,
              float* __restrict__ out, int64_t e, int win_rows, int f) {
  extern __shared__ __align__(16) float win_p[];   // [win_rows, f + kWinPad]
  const int ld = f + kWinPad;
  for (int i = threadIdx.x; i < win_rows * (f / 4); i += blockDim.x) {
    const int r = i / (f / 4), c = i % (f / 4);
    reinterpret_cast<float4*>(win_p + r * ld)[c] =
        __ldg(reinterpret_cast<const float4*>(win + (int64_t)r * f) + c);
  }
  __syncthreads();

  // fragment coordinates (PTX ISA, mma.m16n8k8 .tf32): A element a[j] is at row
  // g + 8 * (j & 1), column t + 4 * (j >> 1); B's b0, b1 at rows t, t + 4 and column g;
  // C's c[j] at row g + 8 * (j >> 1), column 2 * t + (j & 1)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kRows = kMTiles * 16;
  const int64_t tiles = (e + kRows - 1) / kRows;
  const int64_t warp = blockIdx.x * (int64_t)kOnehotWarps + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kOnehotWarps;
  const uint32_t one = __float_as_uint(1.0f);
  for (int64_t tile = warp; tile < tiles; tile += warps) {
    const int64_t row0 = tile * kRows;
    int r[kMTiles][2];   // the window row of fragment rows g and g + 8 (-1: none)
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + m * 16 + g + 8 * h;
        r[m][h] = row < e ? __ldg(idx + row) : -1;
      }
    for (int n0 = 0; n0 < f; n0 += kNTiles * 8) {
      float acc[kMTiles][kNTiles][4] = {};
      for (int k = 0; k < win_rows; k += 8) {
        uint32_t hi[kNTiles][2], lo[kNTiles][2];
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = win_p[(k + t + 4 * h) * ld + n0 + n * 8 + g];
            hi[n][h] = tf32_bits(v);
            lo[n][h] = tf32_bits(v - __uint_as_float(hi[n][h]));  // exact in float32
          }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          const uint32_t a[4] = {r[m][0] == k + t ? one : 0u, r[m][1] == k + t ? one : 0u,
                                 r[m][0] == k + t + 4 ? one : 0u,
                                 r[m][1] == k + t + 4 ? one : 0u};
#pragma unroll
          for (int n = 0; n < kNTiles; ++n) {
            mma_tf32(acc[m][n], a, hi[n][0], hi[n][1]);
            mma_tf32(acc[m][n], a, lo[n][0], lo[n][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + m * 16 + g + 8 * h;
          if (row >= e) continue;
#pragma unroll
          for (int n = 0; n < kNTiles; ++n)
            *reinterpret_cast<float2*>(out + row * f + n0 + n * 8 + 2 * t) =
                make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        }
    }
  }
}

// ------------------------------------------------------ P3: scatter-add
__global__ void __launch_bounds__(kScatterThreads)
dynacc_kernel(const int* __restrict__ idx, const float* __restrict__ msg,
              float* __restrict__ acc, int64_t e, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = (e + kWarpRows - 1) / kWarpRows;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t g = warp; g < groups; g += warps) {
    const int64_t base = g * kWarpRows;
    const int rows = static_cast<int>(e - base < kWarpRows ? e - base : kWarpRows);
    const int mine = lane < rows ? __ldg(idx + base + lane) : 0;
    for (int j = 0; j < rows; ++j) {
      const int r = __shfl_sync(0xffffffffu, mine, j);
      const float* src = msg + (base + j) * f;
      float* dst = acc + (int64_t)r * f;
      for (int c = lane; c < f; c += 32) atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

// ------------------------------------------------------ P4: the row gather
// A warp takes 32 consecutive entries of its list (one a lane): each entry is the
// output row `pos` and the table row `row` it receives. The warp's 32 rows are
// 32 * f4 float4 units u = r * f4 + c (row r of the 32, vector c of it); lane l moves
// units l, l + 32, l + 64, ..., kUnroll loads issued before their stores. The unit's
// (r, c) advances by (32 / f4, 32 % f4) a step, so no lane divides by f4 in the loop.
// Direct path (kOrdered false): the entries are positions in order, row = idx[pos].
// Bucketed path: they are the (pos, row) pairs of the bucket pass, in bucket order.
// The output is written with streaming stores (st.global.cs), so that its stream does
// not push the table's current slice out of L2.
template <bool kOrdered, int kUnroll>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const int2* __restrict__ order, const int* __restrict__ idx,
                   const float4* __restrict__ x, float4* __restrict__ out, int64_t e,
                   int f4) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int r0 = lane / f4, c0 = lane - r0 * f4;
  const int dr = 32 / f4, dc = 32 - dr * f4;
  for (int64_t g = warp; g * 32 < e; g += warps) {
    const int64_t base = g * 32;
    const int rows = static_cast<int>(e - base < 32 ? e - base : 32);
    int pos = 0, row = 0;
    if (lane < rows) {
      if (kOrdered) {
        const int2 pr = __ldcs(order + base + lane);
        pos = pr.x;
        row = pr.y;
      } else {
        pos = static_cast<int>(base + lane);
        row = __ldg(idx + base + lane);
      }
    }
    const int units = rows * f4;
    int r = r0, c = c0;
    for (int u0 = lane; u0 < units + lane; u0 += 32 * kUnroll) {
      float4 v[kUnroll];
      int64_t dst[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int src = r < 32 ? r : 31;   // every lane takes part in the shuffles
        const int from = __shfl_sync(0xffffffffu, row, src);
        const int to = __shfl_sync(0xffffffffu, pos, src);
        const bool live = u0 + 32 * k < units;
        dst[k] = live ? static_cast<int64_t>(to) * f4 + c : -1;
        v[k] = live ? __ldg(x + static_cast<int64_t>(from) * f4 + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        r += dr;
        c += dc;
        if (c >= f4) {
          c -= f4;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (dst[k] >= 0) __stcs(out + dst[k], v[k]);
    }
  }
}

// one instance a (path, unroll): unroll 4, 8 or 16
template <bool kOrdered>
void launch_gather(int unroll, int grid, int threads, cudaStream_t s, const int2* order,
                   const int* idx, const float4* x, float4* out, int64_t e, int f4) {
  if (unroll == 4) {
    gather_rows_kernel<kOrdered, 4><<<grid, threads, 0, s>>>(order, idx, x, out, e, f4);
  } else if (unroll == 8) {
    gather_rows_kernel<kOrdered, 8><<<grid, threads, 0, s>>>(order, idx, x, out, e, f4);
  } else {
    gather_rows_kernel<kOrdered, 16><<<grid, threads, 0, s>>>(order, idx, x, out, e, f4);
  }
}

// In-place exclusive scan of a[0, n) by the whole block (any blockDim up to 1024):
// each thread sums a run of ceil(n / blockDim) entries, the runs' sums are scanned
// with warp shuffles and one shared row of warp totals, and each thread rewrites its
// run as the prefix sums. `a` may be shared or global memory.
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += v;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - own;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// Bucket pass, step 1: block b counts the rows of its kSpan positions by bucket
// (row >> shift) in shared memory and adds them to the totals (zeroed before).
__global__ void __launch_bounds__(kBucketThreads)
bucket_count_kernel(const int* __restrict__ idx, int* __restrict__ totals, int64_t e,
                    int shift, int nb) {
  extern __shared__ int counts[];   // [nb]
  for (int b = threadIdx.x; b < nb; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kSpan);
  const int64_t hi = lo + kSpan < e ? lo + kSpan : e;
  for (int64_t p = lo + threadIdx.x; p < hi; p += blockDim.x)
    atomicAdd(counts + (__ldg(idx + p) >> shift), 1);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    if (counts[b]) atomicAdd(totals + b, counts[b]);
}

// Bucket pass, step 2: the totals become each bucket's first slot (one block).
__global__ void __launch_bounds__(kScanThreads)
bucket_starts_kernel(int* __restrict__ totals, int nb) {
  block_exclusive_scan(totals, nb);
}

// Bucket pass, step 3: block b sorts its kSpan positions by bucket in shared memory
// (a rank from a shared-memory atomic, the runs' offsets by a block scan), reserves
// each bucket's run with one atomicAdd on its cursor, and writes the (pos, row) pairs
// out run by run, so that a warp's stores are consecutive. Runs land in the order the
// blocks reserve them, and a run's pairs in the order of the atomics: both may change
// from call to call; the output does not, since each output row is written once.
__global__ void __launch_bounds__(kBucketThreads)
bucket_scatter_kernel(const int* __restrict__ idx, int* __restrict__ cursor,
                      int2* __restrict__ order, int64_t e, int shift, int nb) {
  extern __shared__ __align__(16) int scatter_smem[];
  int2* stage = reinterpret_cast<int2*>(scatter_smem);   // [kSpan]
  int* offs = scatter_smem + 2 * kSpan;                   // [nb] counts, then offsets
  int* base = offs + nb;                                  // [nb] the runs' first slots
  for (int b = threadIdx.x; b < nb; b += blockDim.x) offs[b] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * static_cast<int64_t>(kSpan);
  int row[kSpanItems], rank[kSpanItems];
#pragma unroll
  for (int k = 0; k < kSpanItems; ++k) {
    const int64_t p = lo + threadIdx.x + k * kBucketThreads;
    row[k] = p < e ? __ldg(idx + p) : -1;
    if (row[k] >= 0) rank[k] = atomicAdd(offs + (row[k] >> shift), 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    base[b] = offs[b] ? atomicAdd(cursor + b, offs[b]) : 0;
  __syncthreads();
  block_exclusive_scan(offs, nb);
#pragma unroll
  for (int k = 0; k < kSpanItems; ++k)
    if (row[k] >= 0)
      stage[offs[row[k] >> shift] + rank[k]] =
          make_int2(static_cast<int>(lo + threadIdx.x + k * kBucketThreads), row[k]);
  __syncthreads();
  const int here = static_cast<int>(e - lo < kSpan ? e - lo : kSpan);
  for (int i = threadIdx.x; i < here; i += blockDim.x) {
    const int2 pr = stage[i];
    const int b = pr.y >> shift;
    order[base[b] + i - offs[b]] = pr;
  }
}

}  // namespace

extern "C" {

// Every pointer is device memory; float32 rows of f values, f > 0 and f % 4 == 0, and
// 16-byte aligned pointers (the wrappers check). Each function launches on `stream`
// and returns cudaGetLastError() after the launch, or cudaErrorInvalidValue (and
// launches nothing) for a bad argument.

// P0: out = x, n floats (n % 4 == 0).
int dgll_probe_copy(const void* x, void* out, long long n, void* stream) {
  if (n < 0 || n % 4 != 0) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  if (n4 == 0) return cudaSuccess;
  const int64_t want = (n4 + kCopyThreads - 1) / kCopyThreads;
  const int64_t cap = 0x7FFFFFFF;
  copy_kernel<<<static_cast<int>(want < cap ? want : cap), kCopyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n4);
  return cudaGetLastError();
}

// P2: out[i] = win[idx[i]] for i < e; win is [win_rows, f].
int dgll_probe_dynread(const void* idx, const void* win, void* out, long long e,
                       int win_rows, int f, void* stream) {
  if (e < 0 || win_rows <= 0 || f <= 0 || f % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(win_rows) * f * sizeof(float);
  if (smem > static_cast<size_t>(max_dynamic_smem())) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      dynread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dynread_kernel<<<sm_count(), kDynreadThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(win), static_cast<float*>(out),
      e, win_rows, f);
  return cudaGetLastError();
}

// P2b: out = onehot(idx)[e, win_rows] @ win[win_rows, f]; win_rows % 8 == 0 and
// f % 32 == 0 (the mma tiles); an index outside [0, win_rows) gives a zero row.
int dgll_probe_onehot(const void* idx, const void* win, void* out, long long e,
                      int win_rows, int f, void* stream) {
  if (e < 0 || win_rows <= 0 || win_rows % 8 != 0 || f <= 0 || f % (kNTiles * 8) != 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(win_rows) * (f + kWinPad) * sizeof(float);
  if (smem > static_cast<size_t>(max_dynamic_smem())) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  onehot_kernel<<<sm_count(), kOnehotWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(win), static_cast<float*>(out),
      e, win_rows, f);
  return cudaGetLastError();
}

// P3: acc = 0 ([out_rows, f], zeroed here), then acc[idx[i]] += msg[i] for i < e.
int dgll_probe_dynacc(const void* idx, const void* msg, void* acc, long long e,
                      int out_rows, int f, void* stream) {
  if (e < 0 || out_rows <= 0 || f <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(acc, 0, static_cast<size_t>(out_rows) * f * sizeof(float), s);
  if (err != cudaSuccess || e == 0) return err;
  const int64_t want = ((e + kWarpRows - 1) / kWarpRows * 32 + kScatterThreads - 1) /
                       kScatterThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  dynacc_kernel<<<static_cast<int>(want < cap ? want : cap), kScatterThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(msg), static_cast<float*>(acc),
      e, f);
  return cudaGetLastError();
}

// P4: out[i] = x[idx[i]] for i < e < 2^31, x [rows, f]. shift < 0: the direct path,
// the gather over the positions in order. shift >= 0: the bucketed path, in one call:
// the bucket pass (buckets of 2^shift table rows, blocks of kSpan positions) writes
// the (pos, row) pairs in bucket order into `order` (int2 [e]) through the cursors
// `cursor` (int [buckets]), then the gather walks them in that order. The gather runs
// `blocks_per_sm` blocks of `threads` threads (a multiple of 32, at most 256) an SM,
// each lane issuing `unroll` (4, 8 or 16) loads before its stores: the warps set how
// many positions are in flight, and so how wide a slice of the table is read at once.
int dgll_probe_gather(const void* idx, const void* x, void* out, void* order, void* cursor,
                      long long e, int rows, int f, int shift, int blocks_per_sm, int threads,
                      int unroll, void* stream) {
  if (e < 0 || e > 0x7FFFFFFFLL || rows <= 0 || f <= 0 || f % 4 != 0 || shift > 30 ||
      blocks_per_sm <= 0 || threads <= 0 || threads > kGatherThreads || threads % 32 != 0 ||
      (unroll != 4 && unroll != 8 && unroll != 16))
    return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cap = static_cast<int64_t>(sm_count()) * blocks_per_sm;
  const int64_t want = ((e + 31) / 32 + threads / 32 - 1) / (threads / 32);
  const int grid = static_cast<int>(want < cap ? want : cap);
  const float4* x4 = static_cast<const float4*>(x);
  float4* out4 = static_cast<float4*>(out);
  const int* ids = static_cast<const int*>(idx);
  if (shift < 0) {
    launch_gather<false>(unroll, grid, threads, s, nullptr, ids, x4, out4, e, f / 4);
    return cudaGetLastError();
  }
  const int nb = ((rows - 1) >> shift) + 1;
  if (nb > kMaxBuckets) return cudaErrorInvalidValue;
  const int spans = static_cast<int>((e + kSpan - 1) / kSpan);
  const size_t scatter_smem = 2 * kSpan * sizeof(int) + 2 * static_cast<size_t>(nb) * sizeof(int);
  if (scatter_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bucket_scatter_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(scatter_smem));
    if (err != cudaSuccess) return err;
  }
  int* cur = static_cast<int*>(cursor);
  int2* o = static_cast<int2*>(order);
  cudaError_t err = cudaMemsetAsync(cur, 0, static_cast<size_t>(nb) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  bucket_count_kernel<<<spans, kBucketThreads, nb * sizeof(int), s>>>(ids, cur, e, shift, nb);
  bucket_starts_kernel<<<1, kScanThreads, 0, s>>>(cur, nb);
  bucket_scatter_kernel<<<spans, kBucketThreads, scatter_smem, s>>>(ids, cur, o, e, shift, nb);
  launch_gather<true>(unroll, grid, threads, s, o, nullptr, x4, out4, e, f / 4);
  return cudaGetLastError();
}

}  // extern "C"
