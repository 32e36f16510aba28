// K8: per-column symmetric int8 quantisation, for Hopper (sm_90a).
//
//   q[i, j] = clip(round(y + u), -127, 127),  s[j] = max(max_i |x[i, j]|, 1e-12) / 127
//
// The per-column scale s is a reduction the wrapper computes (torch.amax, as the JAX
// package leaves it to XLA); this kernel is the elementwise pass that follows it. It
// has two rounding modes, one for each JAX function it serves:
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
// generator per block; here the pass is flat and grid-stride. Each thread takes four
// consecutive elements: one float4 load of x (and of the noise), one float4 load of the
// four columns' scales and one char4 store where d % 4 == 0 and the pointers are
// aligned, four scalar accesses otherwise (a group may then span two rows; each element
// finds its own column).
//
// What bounds it: memory bytes. It reads each x once (4 bytes), the noise once where
// supplied (4 bytes), and writes one byte; the scales (d floats) stay in L1/L2. The
// arithmetic is a few operations per element.
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
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
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
      *reinterpret_cast<char4*>(q + base) = out;
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
// mode 0 "xla" or 1 "floor"; noise_kind 0 none, 1 supplied (noise read), 2 Philox
// (seed read); vec 1 for the float4 / char4 path (the caller checks d % 4 == 0 and the
// alignment). Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// (and launches nothing) for a bad argument.
int dgll_quantize_int8(const void* x, const void* scale, const void* noise, void* q,
                       long long n, int d, int mode, int noise_kind, int vec,
                       unsigned long long seed, void* stream) {
  if (n < 0 || d <= 0 || mode < 0 || mode > 1 || noise_kind < 0 || noise_kind > 2)
    return cudaErrorInvalidValue;
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

}  // extern "C"
