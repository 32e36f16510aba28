// K8: per-column symmetric int8 quantisation, for Hopper (sm_90a).
//
//   q[i, j] = clip(round(y + u), -127, 127),  s[j] = max(max_i |x[i, j]|, 1e-12) / 127
//
// Two entries. dgll_quantize_int8 is the elementwise pass with the scale s given, the
// counterpart of the Pallas kernel's body. dgll_quantize_int8_fill is the whole fill
// (the cache's quantize_int8(x)): it computes s itself, with no [n, d] temporary, where
// the JAX package computes it with XLA in one fused pass (quantize.py:67-74) and a
// torch composition of abs, amax, clamp and a division would write |x| out first. The
// pass has two rounding modes, one for each JAX function it serves:
//
//   mode 0, "xla"   (dgll_tpu/ops/quantize.py:quantize_int8):  y = x / s, then u is
//                   added when the caller asks for stochastic rounding, then round half
//                   to even (jnp.round), then clip;
//   mode 1, "floor" (quantize_int8_pallas, the TPU kernel): y = x * (1 / s), then
//                   floor((y + 0.5) + u), then clip.
//
// and three noise sources for u: none (the cache's fill: nothing is read), a supplied
// float32 [n, d] tensor of uniforms in [-0.5, 0.5) (the tests feed both packages the
// same noise), or counter-based Philox4x32-10 drawn in the kernel: key = seed, counter
// = the index of the element's group of four in the flat [n * d] array, and lane k of
// the group takes word k of the draw as u = (bits >> 8) * 2^-24 - 0.5, the mapping of
// the TPU kernel's on-core generator (quantize.py:92-95). Its bits cannot be the TPU's;
// the plain version (ops/quantize.py:philox_uniform) reproduces them on the host.
//
// It replaces the inner `kernel` of quantize_int8_pallas (dgll_tpu/ops/quantize.py:89,
// launched at :120). That kernel walks 256-row blocks in grid order and seeds the
// generator per block; here the pass is flat and grid-stride, the last group first.
// Each thread takes four consecutive elements: one float4 load of x (and of the
// noise), one float4 load of the four columns' scales and one char4 store where
// d % 4 == 0 and the pointers are aligned, four scalar accesses otherwise (a group may
// then span two rows; each element finds its own column).
//
// The fill: the column maxima of |x| as unsigned bits (see abs_bits: an integer max
// that keeps a NaN, exact and independent of order) in one pass over x, a block
// combining its rows in shared memory and adding one atomicMax a column; the pass's
// last block writes the d scales, s = __fdiv_rn(max(m, 1e-12), 127), the bits of
// torch's column_scale; then the quantize pass. The column-max pass reads rows in a
// front that moves from x's first row to its last, and the pass walks the groups from
// the last one back, so that it first reads the rows that the max pass left in L2 (x
// at the int8 cache's 50,000 x 256 is 51.2 MB, about the size of the card's L2). q is
// written with streaming stores.
//
// What bounds it: memory bytes. The pass reads each x once (4 bytes), the noise once
// where supplied (4 bytes), and writes one byte; the scales (d floats) stay in L1/L2.
// The arithmetic is a few operations per element. The fill reads x a second time,
// less what L2 still holds.
//
// Exactness: the port holds this kernel to exact int8 equality with the JAX functions.
// So every product and sum is written with the IEEE intrinsics (__fdiv_rn, __fmul_rn,
// __fadd_rn), which nvcc never contracts into an FMA, rounding is rintf (half to even)
// or floorf, and this file is never built with --use_fast_math.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kColmaxBlocksPerSm = 4;

enum Noise { kNone = 0, kSupplied = 1, kPhilox = 2 };

__device__ __forceinline__ float uniform_from_bits(unsigned int bits) {
  return __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f), -0.5f);
}

template <int kMode>
__device__ __forceinline__ signed char quantize_one(float x, float s, float u, bool noisy) {
  float r;
  if (kMode == 0) {
    float y = __fdiv_rn(x, s);
    if (noisy) y = __fadd_rn(y, u);
    r = rintf(y);
  } else {
    float y = __fmul_rn(x, __fdiv_rn(1.0f, s));
    float t = __fadd_rn(y, 0.5f);
    if (noisy) t = __fadd_rn(t, u);
    r = floorf(t);
  }
  // NaN (a NaN in x's column makes its scale NaN) gives 0, as PyTorch's and XLA's
  // float-to-int8 conversions give it; fminf and fmaxf alone would give -127
  if (r != r) return 0;
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(r));
}

template <int kMode, int kNoise, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ noise, signed char* __restrict__ q,
                int64_t total, int d, unsigned long long seed) {
  const int64_t groups = (total + 3) / 4;
  const uint2 key = make_uint2(static_cast<unsigned int>(seed),
                               static_cast<unsigned int>(seed >> 32));
  // last group first: the rows the column-max pass of a fill read last are still in L2
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < groups;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t g = groups - 1 - t;
    const int64_t base = 4 * g;
    float u[4] = {0.f, 0.f, 0.f, 0.f};
    if (kNoise == kPhilox) {
      const uint4 ctr = make_uint4(static_cast<unsigned int>(g),
                                   static_cast<unsigned int>(static_cast<uint64_t>(g) >> 32),
                                   0u, 0u);
      const uint4 bits = curand_Philox4x32_10(ctr, key);
      u[0] = uniform_from_bits(bits.x);
      u[1] = uniform_from_bits(bits.y);
      u[2] = uniform_from_bits(bits.z);
      u[3] = uniform_from_bits(bits.w);
    }
    if (kVec) {
      // d % 4 == 0: the group lies in one row, at a column that is a multiple of 4
      const int col = static_cast<int>(base % d);
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + base));
      const float4 sv = __ldg(reinterpret_cast<const float4*>(scale + col));
      if (kNoise == kSupplied) {
        const float4 nv = __ldg(reinterpret_cast<const float4*>(noise + base));
        u[0] = nv.x; u[1] = nv.y; u[2] = nv.z; u[3] = nv.w;
      }
      const bool noisy = kNoise != kNone;
      char4 out;
      out.x = quantize_one<kMode>(xv.x, sv.x, u[0], noisy);
      out.y = quantize_one<kMode>(xv.y, sv.y, u[1], noisy);
      out.z = quantize_one<kMode>(xv.z, sv.z, u[2], noisy);
      out.w = quantize_one<kMode>(xv.w, sv.w, u[3], noisy);
      __stcs(reinterpret_cast<char4*>(q + base), out);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = base + k;
        if (i >= total) break;
        const float uk = kNoise == kSupplied ? __ldg(noise + i) : u[k];
        q[i] = quantize_one<kMode>(__ldg(x + i), __ldg(scale + (int)(i % d)), uk,
                                   kNoise != kNone);
      }
    }
  }
}

// |v| as its float32 bits. For values >= 0 the bits order as the values do, and
// every NaN (its sign cleared) lies above +inf: so an unsigned max of these bits is
// the float max that keeps a NaN, as torch.amax and jnp.max do (fmaxf drops it).
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// The fill's column maxima and scales: block threads are `cols` column units (float4
// of 4 columns, or one column) x `lanes` row lanes; grid.y covers the units. The rows
// go out in a front over the whole grid (row lane + lanes * (block + gridDim.x *
// step)), so the rows read last are x's last rows. Each thread keeps the max of its
// column unit, the block combines its lanes in shared memory and adds one atomicMax a
// column to `colmax` (unsigned bits; colmax and `done` zeroed before the launch). The
// last block to finish (counted in `done`) writes the d scales,
// max(m, 1e-12) / 127, the max keeping a NaN.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
colmax_kernel(const float* __restrict__ x, unsigned* __restrict__ colmax,
              unsigned* __restrict__ done, float* __restrict__ scale, int64_t n, int d,
              int cols, int lanes) {
  constexpr int W = kVec ? 4 : 1;
  __shared__ unsigned part[kThreads * W];
  const int units = d / W;
  const int lane = threadIdx.x / cols, cu = threadIdx.x - lane * cols;
  const int unit = blockIdx.y * cols + cu;
  const bool mine = lane < lanes && unit < units;
  unsigned m[W] = {};
  if (mine) {
#pragma unroll 4
    for (int64_t r = lane + static_cast<int64_t>(lanes) * blockIdx.x; r < n;
         r += static_cast<int64_t>(lanes) * gridDim.x) {
      if constexpr (kVec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + r * d) + unit);
        m[0] = max(m[0], abs_bits(v.x));
        m[1] = max(m[1], abs_bits(v.y));
        m[2] = max(m[2], abs_bits(v.z));
        m[3] = max(m[3], abs_bits(v.w));
      } else {
        m[0] = max(m[0], abs_bits(__ldg(x + r * d + unit)));
      }
    }
  }
  for (int i = threadIdx.x; i < cols * W; i += blockDim.x) part[i] = 0u;
  __syncthreads();
  if (mine) {
#pragma unroll
    for (int k = 0; k < W; ++k) atomicMax(part + cu * W + k, m[k]);
  }
  __syncthreads();
  const int first = blockIdx.y * cols * W;
  for (int i = threadIdx.x; i < cols * W && first + i < d; i += blockDim.x)
    atomicMax(colmax + first + i, part[i]);
  __shared__ bool last;
  __threadfence();   // this block's maxima are in L2 before it counts itself done
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    scale[j] = __fdiv_rn(__uint_as_float(max(__ldcg(colmax + j), __float_as_uint(1e-12f))),
                         127.0f);
}

// the card's SM count, read once (a call of a few tens of microseconds waits on it)
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <int kMode, int kNoise>
void launch(bool vec, const float* x, const float* scale, const float* noise,
            signed char* q, int64_t total, int d, unsigned long long seed,
            cudaStream_t stream) {
  const int64_t groups = (total + 3) / 4;
  const int blocks = static_cast<int>(
      groups / kThreads + 1 < kMaxBlocks ? groups / kThreads + 1 : kMaxBlocks);
  if (vec) {
    quantize_kernel<kMode, kNoise, true><<<blocks, kThreads, 0, stream>>>(
        x, scale, noise, q, total, d, seed);
  } else {
    quantize_kernel<kMode, kNoise, false><<<blocks, kThreads, 0, stream>>>(
        x, scale, noise, q, total, d, seed);
  }
}

template <int kMode>
void launch_mode(int noise_kind, bool vec, const float* x, const float* scale,
                 const float* noise, signed char* q, int64_t total, int d,
                 unsigned long long seed, cudaStream_t stream) {
  if (noise_kind == kSupplied) {
    launch<kMode, kSupplied>(vec, x, scale, noise, q, total, d, seed, stream);
  } else if (noise_kind == kPhilox) {
    launch<kMode, kPhilox>(vec, x, scale, noise, q, total, d, seed, stream);
  } else {
    launch<kMode, kNone>(vec, x, scale, noise, q, total, d, seed, stream);
  }
}

}  // namespace

extern "C" {

// x, noise: float32 [n, d]; scale: float32 [d]; q: int8 [n, d], all device memory.
// flags = mode | noise_kind << 1 | vec << 3: mode 0 "xla" or 1 "floor"; noise_kind 0
// none, 1 supplied (noise read), 2 Philox (seed read); vec 1 for the float4 / char4
// path (the caller checks d % 4 == 0 and the alignment). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (and launches nothing) for a bad argument.
int dgll_quantize_int8(const void* x, const void* scale, const void* noise, void* q,
                       long long n, int d, int flags, unsigned long long seed,
                       void* stream) {
  const int mode = flags & 1, noise_kind = (flags >> 1) & 3, vec = (flags >> 3) & 1;
  if (n < 0 || d <= 0 || flags >> 4 || noise_kind > 2) return cudaErrorInvalidValue;
  if (noise_kind == kSupplied && noise == nullptr) return cudaErrorInvalidValue;
  if (vec && d % 4 != 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n) * d;
  if (total == 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* nf = static_cast<const float*>(noise);
  signed char* qc = static_cast<signed char*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    launch_mode<0>(noise_kind, vec != 0, xf, sf, nf, qc, total, d, seed, s);
  } else {
    launch_mode<1>(noise_kind, vec != 0, xf, sf, nf, qc, total, d, seed, s);
  }
  return cudaGetLastError();
}

// The whole fill in one call: scale (float32 [d]) from x's column maxima, then q
// (int8 [n, d], n > 0) as dgll_quantize_int8 computes it with that scale. scratch is
// d + 1 unsigned words (the maxima and a block count). Three operations on `stream`:
// the scratch zeroed, the column-max pass (its last block writes the scales), the
// quantize pass (last rows first). flags as above; vec 1 also needs scale 16-byte and
// q 4-byte aligned (the caller checks).
int dgll_quantize_int8_fill(const void* x, const void* noise, void* q, void* scale,
                            void* scratch, long long n, int d, int flags,
                            unsigned long long seed, void* stream) {
  const int noise_kind = (flags >> 1) & 3, vec = (flags >> 3) & 1;
  if (n <= 0 || d <= 0 || flags >> 4 || noise_kind > 2 ||
      (noise_kind == kSupplied && noise == nullptr) || (vec && d % 4 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* cm = static_cast<unsigned*>(scratch);
  cudaError_t err = cudaMemsetAsync(cm, 0, (static_cast<size_t>(d) + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  const int units = vec ? d / 4 : d;
  const int cols = units < kThreads ? units : kThreads;
  const int lanes = kThreads / cols;
  const int grid_y = (units + cols - 1) / cols;
  const int64_t fronts = (n + lanes - 1) / lanes;
  const int64_t want = (static_cast<int64_t>(sm_count()) * kColmaxBlocksPerSm + grid_y - 1) /
                       grid_y;
  const dim3 grid(static_cast<unsigned>(fronts < want ? fronts : want),
                  static_cast<unsigned>(grid_y));
  const float* xf = static_cast<const float*>(x);
  float* sc = static_cast<float*>(scale);
  if (vec) {
    colmax_kernel<true><<<grid, kThreads, 0, s>>>(xf, cm, cm + d, sc, n, d, cols, lanes);
  } else {
    colmax_kernel<false><<<grid, kThreads, 0, s>>>(xf, cm, cm + d, sc, n, d, cols, lanes);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dgll_quantize_int8(x, sc, noise, q, n, d, flags, seed, stream);
}

}  // extern "C"
