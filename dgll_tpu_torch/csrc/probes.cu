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
// adds them into a 4 MiB accumulator that stays in the 50 MB L2. P2b is three dense
// products of E x WIN x F multiply-adds on the tensor cores (see below).
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
// * P2b: the one-hot product on the tensor cores, as the TPU's MXU computes it. A row
//   gather gives the same function, but P2 is that gather; P2b measures the one-hot
//   product, and a P2b that gathered would make the probe say nothing. wgmma
//   m64nNk16 with bfloat16 inputs and float32 sums. Each block splits the window once
//   into three bfloat16 parts, hi = x cut to bfloat16, mid = x - hi cut, lo = x - hi
//   - mid (cut toward zero; see split3): both subtractions are exact and the parts
//   hold all 24 bits of x's significand; G is 0 or 1, exact in bfloat16, and each
//   output element has one nonzero term in each product. So G @ hi + G @ mid + G @
//   lo, added in that order, is win[idx] exactly wherever lo and mid are normal:
//   2^-103 <= |x| <= FLT_MAX, and 0. (Rounding the parts to nearest is as fast and as
//   exact on the H100, but its hi overflows above 3.3961e38, and its partial sums
//   can leave x's binade.) The three products are 6 E WIN F operations, 0.83 ms at
//   bfloat16's 989 TFLOP/s at the probe's size (two TF32 products, hi + lo, would be
//   1.11 ms at 495), beside 0.65 ms for the 2 GB of output at 3.35 TB/s: the tensor
//   cores bound it, the output's writes run beside them. The parts sit in shared
//   memory in wgmma's K-major layout without swizzle (core matrices of 8 columns x 8
//   rows), 3 x 64 KB at WIN = 256 and F = 128. Where 128 does not divide F, or the
//   parts would not fit, the window is cut into column slices of 64, 32 or 16, one
//   pass each. G never exists in memory:
//   each thread holds the window rows of its two fragment rows and builds its four
//   bfloat16x2 A registers by comparison at every K step, once for the three
//   products. Two warpgroups a block walk M tiles of 64 rows, two K steps in flight
//   each; one's epilogue (8-byte streaming stores straight from the accumulators, so
//   that the output does not crowd L2) runs while the other's products do. It
//   replaces a design on mma.sync at TF32 (win split into hi + lo, re-split at every
//   fragment load by every warp, no overlap of stores and products), which mma.sync's
//   throughput held to about 42% of TF32's wgmma peak.
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
constexpr int kOnehotGroups = 2;    // P2b: warpgroups a block
constexpr int kTileRows = 64;       // P2b: rows of an M tile (wgmma's M)
constexpr int kParts = 3;           // P2b: bfloat16 parts of the window, hi + mid + lo
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
// x = hi + mid + lo exactly, three bfloat16 values (their bits in .x, .y, .z), each
// the one before's remainder cut to its top 8 significant bits (rounded toward zero):
// both subtractions are exact in float32, what is left after mid has at most 8
// significant bits, and every part has x's sign and at most its magnitude, so no part
// overflows and each partial sum hi, hi + mid, x lies in x's own binade.
__device__ __forceinline__ uint3 split3(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(hi);
  const uint32_t mid = __float_as_uint(r) & 0xFFFF0000u;
  const float lo = r - __uint_as_float(mid);
  return make_uint3(hi >> 16, mid >> 16, __float_as_uint(lo) >> 16);
}

// Byte offset of element (k, n) of a [kp, ns] window part in wgmma's K-major layout
// without swizzle: core matrices of 8 columns x 8 window rows, 128 contiguous bytes
// (a column's 8 rows are 16 bytes), the two 8-row halves of a K step 128 bytes apart
// (the descriptor's leading offset), the 8-column groups 256 apart (its stride
// offset), the K steps ns * 32 apart.
__device__ __forceinline__ int core_offset(int k, int n, int ns) {
  return (k >> 4) * ns * 32 + (n >> 3) * 256 + ((k >> 3) & 1) * 128 + (n & 7) * 16 +
         (k & 7) * 2;
}

// A shared-memory matrix descriptor for B at byte address `addr`, laid out as
// core_offset says: start >> 4, leading offset 128 >> 4, stride offset 256 >> 4, no
// swizzle
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

#define P2B_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define P2B_ACC8(i) P2B_ACC4(i), P2B_ACC4(i + 4)
#define P2B_ACC16(i) P2B_ACC8(i), P2B_ACC8(i + 8)
#define P2B_ACC32(i) P2B_ACC16(i), P2B_ACC16(i + 16)
#define P2B_ACC64(i) P2B_ACC32(i), P2B_ACC32(i + 32)

// d = a @ B (scale_d 0) or d += a @ B (scale_d 1), one wgmma m64nNk16 with float32
// sums: a is the warpgroup's 64 x 16 bfloat16 A in registers, B (16 x N bfloat16) is
// read from shared memory through `desc`. Accumulator element d[i] of a thread is at
// row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane % 4)
// + (i & 1); A's register a[j] holds columns 2 * (lane % 4) + 8 * (j >> 1) and the
// next one (the lower in the low half) of row 16 * warp + lane / 4 + 8 * (j & 1).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : P2B_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : P2B_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : P2B_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : P2B_ACC64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The accumulators are written by wgmma after the instruction that names them: this
// keeps the compiler from moving their reads above the wait that completes them, or
// their last reads below a tile's first product.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A's pair of columns (c, c + 1), bfloat16 1.0 (0x3F80) where the row's window index
// lies `rel` = index - c columns past c at 0 or 1, else 0.
__device__ __forceinline__ uint32_t onehot_pair(int rel) {
  return rel == 0 ? 0x3F80u : rel == 1 ? 0x3F800000u : 0u;
}

// One K step of a tile: A built from the rows' indices (rel0, rel1: index - 2 * t -
// 16 * step, of rows g and g + 8), then its product with hi, mid and lo of the step's
// 16 window rows (at byte address `addr`, the parts `part_bytes` apart), in that order,
// into d; one commit group.
template <int NS>
__device__ __forceinline__ void onehot_step(float (&d)[NS / 2], uint32_t (&a)[4], int rel0,
                                            int rel1, uint32_t addr, int part_bytes,
                                            int scale_d) {
  a[0] = onehot_pair(rel0);
  a[1] = onehot_pair(rel1);
  a[2] = onehot_pair(rel0 - 8);
  a[3] = onehot_pair(rel1 - 8);
  wgmma_fence();
  wgmma_rs<NS>(d, a, b_desc(addr), scale_d);
  wgmma_rs<NS>(d, a, b_desc(addr + part_bytes), 1);
  wgmma_rs<NS>(d, a, b_desc(addr + 2 * part_bytes), 1);
  wgmma_commit();
}

size_t onehot_smem(int win_rows, int ns) {
  return static_cast<size_t>(kParts) * ((win_rows + 15) / 16 * 16) * ns * 2;
}

// A persistent block of kOnehotGroups warpgroups. For each pass over NS output
// columns n0.., the block splits that column slice of the window into its three parts
// in shared memory (rows padded with zeros up to kp, a multiple of 16), then each
// warpgroup walks its M tiles of 64 rows: K steps of 16 window rows, each one A built
// in registers and three wgmma, two steps in flight (the A registers alternate, and
// a step waits for the one before the last before its A is rebuilt); then the tile's
// 64 x NS sums go out as 8-byte streaming stores while the other warpgroup's products
// run. A row at or past e takes index -1, which no column matches.
template <int NS>
__global__ void __launch_bounds__(kOnehotGroups * 128, 1)
onehot_kernel(const int* __restrict__ idx, const float* __restrict__ win,
              float* __restrict__ out, int64_t e, int win_rows, int f) {
  extern __shared__ __align__(128) unsigned char parts[];   // [kParts][kp, NS] bfloat16
  const int kp = (win_rows + 15) / 16 * 16, steps = kp / 16, part_bytes = kp * NS * 2;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(parts));
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t tiles = (e + kTileRows - 1) / kTileRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kOnehotGroups;
  auto ids_of = [&](int64_t tile) {
    const int64_t r = tile * kTileRows + warp * 16 + g;
    return make_int2(r < e ? __ldg(idx + r) : -1, r + 8 < e ? __ldg(idx + r + 8) : -1);
  };
  float d[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) d[i] = 0.f;
  uint32_t a0[4], a1[4];
  for (int n0 = 0; n0 < f; n0 += NS) {
    __syncthreads();   // every product of the last pass has completed (wait_group 0)
    for (int i = threadIdx.x; i < kp / 8 * NS; i += blockDim.x) {
      const int k0 = i / NS * 8, n = i % NS;
      uint32_t w[kParts][4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float* src = win + static_cast<int64_t>(k0 + j) * f + n0 + n;
        const uint3 x0 = split3(k0 + j < win_rows ? __ldg(src) : 0.f);
        const uint3 x1 = split3(k0 + j + 1 < win_rows ? __ldg(src + f) : 0.f);
        w[0][j / 2] = x0.x | (x1.x << 16);
        w[1][j / 2] = x0.y | (x1.y << 16);
        w[2][j / 2] = x0.z | (x1.z << 16);
      }
      const int off = core_offset(k0, n, NS);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        *reinterpret_cast<uint4*>(parts + p * part_bytes + off) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma's reads
    __syncthreads();

    int64_t tile = blockIdx.x * static_cast<int64_t>(kOnehotGroups) + wg;
    int2 next = ids_of(tile);
    for (; tile < tiles; tile += stride) {
      const int rel0 = next.x - 2 * t, rel1 = next.y - 2 * t;
      next = ids_of(tile + stride);
      fence_acc(d);
      for (int s = 0; s < steps; s += 2) {
        onehot_step<NS>(d, a0, rel0 - 16 * s, rel1 - 16 * s, base + s * NS * 32, part_bytes,
                        s > 0);
        wgmma_wait<1>();
        if (s + 1 < steps) {
          onehot_step<NS>(d, a1, rel0 - 16 * (s + 1), rel1 - 16 * (s + 1),
                          base + (s + 1) * NS * 32, part_bytes, 1);
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      const int64_t row = tile * kTileRows + warp * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= e) continue;
        float* dst = out + (row + 8 * h) * f + n0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j)
          __stcs(reinterpret_cast<float2*>(dst + 8 * j),
                 make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
      }
    }
  }
}

template <int NS>
cudaError_t launch_onehot(const int* idx, const float* win, float* out, int64_t e,
                          int win_rows, int f, cudaStream_t s) {
  const size_t smem = onehot_smem(win_rows, NS);
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t want = ((e + kTileRows - 1) / kTileRows + kOnehotGroups - 1) / kOnehotGroups;
  const int64_t cap = sm_count();
  onehot_kernel<NS><<<static_cast<int>(want < cap ? want : cap), kOnehotGroups * 128, smem, s>>>(
      idx, win, out, e, win_rows, f);
  return cudaGetLastError();
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
// f % 32 == 0; an index outside [0, win_rows) gives a zero row. Each pass takes the
// widest column slice of 128, 64, 32 or 16 that divides f and whose three parts fit
// in shared memory.
int dgll_probe_onehot(const void* idx, const void* win, void* out, long long e,
                      int win_rows, int f, void* stream) {
  if (e < 0 || win_rows <= 0 || win_rows % 8 != 0 || f <= 0 || f % 32 != 0)
    return cudaErrorInvalidValue;
  int ns = 128;
  while (ns >= 16 && (f % ns != 0 || onehot_smem(win_rows, ns) >
                                         static_cast<size_t>(max_dynamic_smem())))
    ns /= 2;
  if (ns < 16) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(win);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 128: return launch_onehot<128>(i, w, o, e, win_rows, f, s);
    case 64: return launch_onehot<64>(i, w, o, e, win_rows, f, s);
    case 32: return launch_onehot<32>(i, w, o, e, win_rows, f, s);
    default: return launch_onehot<16>(i, w, o, e, win_rows, f, s);
  }
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
