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
// * P4: the TPU's per-row DMA with DEPTH = 8 copies in flight becomes Hopper's 1-D
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes): one lane of a one-warp
//   block issues one F * 4-byte copy a row from global into a ring of 8 shared-memory
//   slots, each with its mbarrier; the warp waits on a slot's barrier, writes the row
//   out, and the slot is refilled with the row 8 ahead. A block walks 512-row chunks
//   (grid-stride); a shared-memory ring of 512 rows would be 256 KB, above the
//   227 KB a block may have, so each row is written out as it lands instead of the
//   whole chunk at its end.
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
constexpr int kDepth = 8;           // P4: copies in flight a block (the TPU's DEPTH)
constexpr int kDmaBlocksPerSm = 16;

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

// ------------------------------------------------- P4: per-row bulk copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival that also expects `bytes` of transactions, then the copy that brings them
__device__ __forceinline__ void bulk_row(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(32)
dma_kernel(const int* __restrict__ idx, const float* __restrict__ x,
           float* __restrict__ out, int64_t e, int chunk, int f) {
  extern __shared__ __align__(128) unsigned char dma_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(dma_smem);               // [kDepth]
  float* ring = reinterpret_cast<float*>(dma_smem + 128);               // [kDepth, f]
  const int lane = threadIdx.x;
  const uint32_t bytes = static_cast<uint32_t>(f) * 4u;
  const int64_t chunks = (e + chunk - 1) / chunk;
  // this block's rows, in order: the rows of chunks blockIdx.x, + gridDim.x, ...
  const int64_t my_chunks = blockIdx.x < chunks ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto row_of = [&](int64_t t) -> int64_t {   // t-th row of this block, or -1
    const int64_t c = blockIdx.x + (t / chunk) * (int64_t)gridDim.x;
    const int64_t row = c * chunk + t % chunk;
    return (t / chunk < my_chunks && row < e) ? row : -1;
  };
  if (lane == 0) {
    for (int s = 0; s < kDepth; ++s) bar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if (lane == 0) {                      // warm up the pipeline
    for (int s = 0; s < kDepth; ++s) {
      const int64_t row = row_of(s);
      if (row < 0) break;
      bulk_row(ring + s * f, x + (int64_t)__ldg(idx + row) * f, bytes, bars + s);
    }
  }
  const int f4 = f / 4;
  for (int64_t t = 0;; ++t) {
    const int64_t row = row_of(t);
    if (row < 0) break;
    const int s = static_cast<int>(t % kDepth);
    bar_wait(bars + s, static_cast<uint32_t>((t / kDepth) & 1));
    const float4* src = reinterpret_cast<const float4*>(ring + s * f);
    float4* dst = reinterpret_cast<float4*>(out + row * f);
    for (int c = lane; c < f4; c += 32) dst[c] = src[c];
    __syncwarp();
    if (lane == 0) {
      const int64_t next = row_of(t + kDepth);
      if (next >= 0) {
        // the warp's reads of the slot (generic proxy) come before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_row(ring + s * f, x + (int64_t)__ldg(idx + next) * f, bytes, bars + s);
      }
    }
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

// P4: out[i] = x[idx[i]] for i < e, by one bulk copy a row, 8 in flight a block; a
// block walks `chunk`-row chunks.
int dgll_probe_dma(const void* idx, const void* x, void* out, long long e, int chunk,
                   int f, void* stream) {
  if (e < 0 || chunk <= 0 || f <= 0 || f % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem = 128 + static_cast<size_t>(kDepth) * f * sizeof(float);
  if (smem > static_cast<size_t>(max_dynamic_smem())) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t chunks = (e + chunk - 1) / chunk;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kDmaBlocksPerSm;
  dma_kernel<<<static_cast<int>(chunks < cap ? chunks : cap), 32, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(x), static_cast<float*>(out), e,
      chunk, f);
  return cudaGetLastError();
}

}  // extern "C"
