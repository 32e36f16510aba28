// GCNII's layer between two K1 sums, forward and backward, for Hopper (sm_90a).
//
// A GCNII layer l (nn/models.py GCNII, nn/conv.py GCN2Conv) takes K1's sum
// agg = P x, then, per row of width F:
//
//   s   = lerp(agg, h0, alpha)                      the initial residual
//   z   = beta (s W) + (1 - beta) s                 the identity mapping, W [F, F]
//   h   = relu(z)                                   NaN kept, as torch.relu keeps it
//   out = where(u < keep, h * (1 / keep), 0)        the next layer's dropout
//
// and out is the next K1 sum's input (or the head's, after the last layer). The
// forward kernel computes all of it in registers and writes out, s (which the
// backward needs for dW) and one byte a value, flag = !(z <= 0) and kept (relu's
// backward, threshold_backward, passes the gradient wherever z <= 0 is false, NaN
// included). The backward kernel reads the gradient g of out, the flags and s:
//
//   g_z   = flag ? g * (1 / keep) : 0
//   g_s   = (1 - beta) g_z + beta (g_z W^T)
//   g_agg = (1 - alpha) g_s                         into K1's padded row space, the
//                                                   rows past n zero
//   g_h0  = alpha g_s
//   dW    = beta s^T g_z
//
// It replaces no TPU kernel: the JAX package has no GCNII. It replaces a chain of
// PyTorch operations over [n, F] float32 (dropout's compare, divide and select,
// lerp, addmm with its copy of s, relu, and their backward), about 45 passes over
// the tensor a layer, by 5.25 passes forward and 4.25 backward.
//
// What bounds it: memory bytes. At F = 64 a row is 256 bytes and its product 4,096
// multiply-adds: 16 flops a byte forward, 32 backward (two products), against the
// card's 20 flops a byte of float32 outside the tensor cores. The products run in
// float32 FMA (no TF32), each sum over k in order 0 .. F-1.
//
// Two designs, one per range of F. Both give every thread (tx, ty) of a 256-thread
// block the 4 x 4 outputs of columns 4 tx .. 4 tx + 3 and rows ty + TY i, i < 4: it
// loads them as float4, so every global access is a 16-byte load or store and a warp
// covers whole contiguous rows, and its products come from float4 reads of a tile in
// shared memory (padded by 4 floats a row so that the warp's rows fall in distinct
// banks) and of W.
//
// F = 16, 32 or 64 (the "whole" kernels): W (or W^T) whole in shared memory, a block
// of TX = F / 4 threads across a row walks tiles of R rows (64 at F = 64) with a
// grid-stride loop, the grid as many blocks as fit the card at once. The forward
// loads the next tile's inputs into registers while it computes the current one (2
// blocks an SM); the backward, which does two products a tile, overlaps loads and
// products across its 3 blocks an SM instead (prefetching there, or 8 x 8 outputs a
// thread, ran slower on the card). The backward's dW is one 4 x 4 block of the F x F
// product a thread, summed over the block's rows in order, written once a block as a
// partial; a second kernel adds the partials in block order.
//
// Any other F that is a multiple of 4 (the "tiled" kernels): a block owns a slab of
// 64 output columns of a tile of 64 rows, and walks k in chunks of 64 through shared
// memory, the chunk of s (or g_z) recomputed from its inputs and the chunk of W (or
// W^T) loaded beside it, so that shared memory holds 33 KB whatever F is. The blocks
// of one tile are neighbours in the grid, so that the inputs the F / 64 slabs each
// read come from L2 after the first. The backward's dW is a third kernel: a block
// owns a 64 x 64 block of dW and a fixed share of the row tiles, and writes its sum
// as a partial, added in order by the same second kernel.
//
// No atomics: every result is bitwise repeatable.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of a tile a thread owns

template <int F>
struct Tile {
  static constexpr int TX = F / 4;              // threads across a row's columns
  static constexpr int TY = kThreads / TX;      // row groups of a block
  static constexpr int R = TY * kRows;          // rows of a tile
  static constexpr int LD = F + 4;              // a tile row's stride in shared memory
  static constexpr int kFwdSmem = (F * F + R * LD) * 4;
  static constexpr int kBwdSmem = (F * F + 2 * R * LD) * 4;
};

// the tiled kernels: 64 rows x 64 columns a block, k in chunks of 64
constexpr int kSlab = 64;                       // output columns of a block, k of a chunk
constexpr int kTX = kSlab / 4;                  // 16 threads across them
constexpr int kTY = kThreads / kTX;             // 16 row groups
constexpr int kTileR = kTY * kRows;             // 64 rows a tile
constexpr int kLd = kSlab + 4;                  // a chunk row's stride in shared memory

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// read once, not kept in L2 for another block
__device__ __forceinline__ float4 ld4_stream(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// torch.lerp's rule: self + w (end - self) for |w| < 0.5, else end - (end - self)(1 - w)
__device__ __forceinline__ float lerp1(float a, float b, float w) {
  return fabsf(w) < 0.5f ? fmaf(w, b - a, a) : fmaf(-(b - a), 1.0f - w, b);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float w) {
  return make_float4(lerp1(a.x, b.x, w), lerp1(a.y, b.y, w), lerp1(a.z, b.z, w),
                     lerp1(a.w, b.w, w));
}

// the forward's four outputs of one row from z = beta acc + (1 - beta) s: relu (NaN
// kept), the dropout's select where kDrop (bit c of `kept` keeps column c), the flags
template <bool kDrop>
__device__ __forceinline__ void relu_drop(const float (&acc)[4], float4 sv, uint32_t kept,
                                          float beta, float one_m_beta, float scale,
                                          float* out, uint8_t* flags) {
  float o[4];
  uint8_t fl[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float z = fmaf(beta, acc[c], one_m_beta * at(sv, c));
    const bool pos = !(z <= 0.0f);
    const float h = pos ? z : 0.0f;
    if (kDrop) {
      const bool k = (kept >> c) & 1u;
      o[c] = k ? h * scale : 0.0f;
      fl[c] = pos && k;
    } else {
      o[c] = h;
      fl[c] = pos;
    }
  }
  st4(out, make_float4(o[0], o[1], o[2], o[3]));
  *reinterpret_cast<uchar4*>(flags) = make_uchar4(fl[0], fl[1], fl[2], fl[3]);
}

__device__ __forceinline__ uint32_t kept4(float4 u, float keep) {
  return (uint32_t)(u.x < keep) | (uint32_t)(u.y < keep) << 1 | (uint32_t)(u.z < keep) << 2 |
         (uint32_t)(u.w < keep) << 3;
}

// g_z of four values: the gradient g where the flag is set, scaled by 1 / keep
__device__ __forceinline__ float4 grad_z4(float4 gv, uchar4 f, float scale) {
  return make_float4(f.x ? gv.x * scale : 0.0f, f.y ? gv.y * scale : 0.0f,
                     f.z ? gv.z * scale : 0.0f, f.w ? gv.w * scale : 0.0f);
}

// acc[i][c] += sum_k a[row_i][k] * b[k][4 tx + c], k in order 0 .. K-1, a's rows
// ty + TY i of a tile in shared memory (stride LDA), b [K][LDB] in shared memory
template <int K, int LDA, int LDB, int TY>
__device__ __forceinline__ void tile_product(const float* a, const float* b, int tx, int ty,
                                             float (&acc)[kRows][4]) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 av[kRows], bv[4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + TY * i) * LDA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bv[kk] = *reinterpret_cast<const float4*>(b + (k + kk) * LDB + 4 * tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float x = at(av[i], kk);
        acc[i][0] = fmaf(x, bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(x, bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(x, bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(x, bv[kk].w, acc[i][3]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRows][4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
}

// acc[a][b] += sum_r s[r][4 py + a] g[r][4 px + b] over the R rows of two tiles in
// shared memory (stride LD), r in order
template <int R, int LD>
__device__ __forceinline__ void outer_sum(const float* s, const float* g, int px, int py,
                                          float (&acc)[4][4]) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(s + r * LD + 4 * py);
    const float4 b = *reinterpret_cast<const float4*>(g + r * LD + 4 * px);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = at(a, k);
      acc[k][0] = fmaf(x, b.x, acc[k][0]);
      acc[k][1] = fmaf(x, b.y, acc[k][1]);
      acc[k][2] = fmaf(x, b.z, acc[k][2]);
      acc[k][3] = fmaf(x, b.w, acc[k][3]);
    }
  }
}

// K1's padded rows n .. n_rows-1 of g_agg take no gradient (F a multiple of 4)
__device__ __forceinline__ void zero_padded_rows(float* g_agg, int n, int n_rows, int f) {
  for (int64_t i = (int64_t)n * f + 4 * threadIdx.x; i < (int64_t)n_rows * f;
       i += 4 * kThreads)
    st4(g_agg + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
}

// a tile's row ty + TY i of thread (tx, ty): its index in [n, F] (or -1 past n or past
// the last tile)
template <int F>
__device__ __forceinline__ int64_t tile_off(int tile, int n_tiles, int i, int tx, int ty,
                                            int n) {
  using T = Tile<F>;
  const int r = tile * T::R + ty + T::TY * i;
  return tile < n_tiles && r < n ? (int64_t)r * F + 4 * tx : -1;
}

template <int F, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
gcnii_fused_fwd_kernel(const float* __restrict__ agg, const float* __restrict__ h0,
                       const float* __restrict__ w, const float* __restrict__ u,
                       float* __restrict__ out, float* __restrict__ s_out,
                       uint8_t* __restrict__ flags, int n, float alpha, float beta,
                       float one_m_beta, float keep, float scale) {
  using T = Tile<F>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // W [F][F]
  float* ss = ws + F * F;                       // the tile of s [R][LD]
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  for (int i = tid; i < F * F / 4; i += kThreads)
    reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  const int n_tiles = (n + T::R - 1) / T::R;
  // the next tile's inputs, loaded while the block computes the current one
  float4 a[kRows], b[kRows], uv[kRows];
  auto fetch = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t off = tile_off<F>(tile, n_tiles, i, tx, ty, n);
      a[i] = b[i] = uv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (off >= 0) {
        a[i] = ld4_stream(agg + off);
        b[i] = ld4(h0 + off);
        if (kDrop) uv[i] = ld4_stream(u + off);
      }
    }
  };
  fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    uint32_t kept = 0;  // bits 4 i .. 4 i + 3: the dropout keeps row i's columns
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 v = lerp4(a[i], b[i], alpha);
      const int64_t off = tile_off<F>(tile, n_tiles, i, tx, ty, n);
      if (off >= 0) st4(s_out + off, v);
      st4(ss + (ty + T::TY * i) * T::LD + 4 * tx, v);
      if (kDrop) kept |= kept4(uv[i], keep) << (4 * i);
    }
    __syncthreads();  // the tile of s (and, the first time, W) is in shared memory
    fetch(tile + gridDim.x);
    float acc[kRows][4];
    zero(acc);
    tile_product<F, T::LD, F, T::TY>(ss, ws, tx, ty, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t off = tile_off<F>(tile, n_tiles, i, tx, ty, n);
      if (off < 0) continue;
      const float4 sv = *reinterpret_cast<const float4*>(ss + (ty + T::TY * i) * T::LD + 4 * tx);
      relu_drop<kDrop>(acc[i], sv, kept >> (4 * i), beta, one_m_beta, scale, out + off,
                       flags + off);
    }
    __syncthreads();  // the tile of s is read: the next tile may overwrite it
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gcnii_fused_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ flags,
                       const float* __restrict__ s, const float* __restrict__ w,
                       float* __restrict__ g_agg, float* __restrict__ g_h0,
                       float* __restrict__ partial, int n, int n_rows, float alpha,
                       float one_m_alpha, float beta, float one_m_beta, float scale) {
  using T = Tile<F>;
  constexpr int PX = F / 4;  // dW: a thread's 4 x 4 block (rows 4 py.., columns 4 px..)
  extern __shared__ float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);  // W^T [F][F]: wt[j][k] = W[k][j]
  float* gs = wt + F * F;                       // the tile of g_z [R][LD]
  float* ss = gs + T::R * T::LD;                // the tile of s [R][LD]
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int px = tid % PX, py = tid / PX;
  const bool owns_dw = tid < PX * PX;
  for (int i = tid; i < F * F; i += kThreads) wt[(i % F) * F + i / F] = __ldg(w + i);
  if (blockIdx.x == 0) zero_padded_rows(g_agg, n, n_rows, F);
  float dw[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dw[a][b] = 0.0f;
  const int n_tiles = (n + T::R - 1) / T::R;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T::R;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = ty + T::TY * i, r = row0 + lr;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = v;
      if (r < n) {
        const int64_t off = (int64_t)r * F + 4 * tx;
        v = grad_z4(ld4_stream(g + off), __ldcs(reinterpret_cast<const uchar4*>(flags + off)),
                    scale);
        sv = ld4_stream(s + off);
      }
      st4(gs + lr * T::LD + 4 * tx, v);
      st4(ss + lr * T::LD + 4 * tx, sv);
    }
    __syncthreads();  // the tiles of g_z and s (and, the first time, W^T) are in place
    float acc[kRows][4];
    zero(acc);
    tile_product<F, T::LD, F, T::TY>(gs, wt, tx, ty, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = ty + T::TY * i, r = row0 + lr;
      if (r >= n) continue;
      const int64_t off = (int64_t)r * F + 4 * tx;
      const float4 gz = *reinterpret_cast<const float4*>(gs + lr * T::LD + 4 * tx);
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = fmaf(beta, acc[i][c], one_m_beta * at(gz, c));
      st4(g_agg + off, make_float4(one_m_alpha * d[0], one_m_alpha * d[1],
                                   one_m_alpha * d[2], one_m_alpha * d[3]));
      st4(g_h0 + off, make_float4(alpha * d[0], alpha * d[1], alpha * d[2], alpha * d[3]));
    }
    // dW[4 py + a][4 px + b] += s[r][4 py + a] g_z[r][4 px + b], r in order
    if (owns_dw) outer_sum<T::R, T::LD>(ss, gs, px, py, dw);
    __syncthreads();  // both tiles are read: the next tile may overwrite them
  }
  if (owns_dw) {
    float* p = partial + (int64_t)blockIdx.x * F * F;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st4(p + (4 * py + k) * F + 4 * px, make_float4(dw[k][0], dw[k][1], dw[k][2], dw[k][3]));
  }
}

// The tiled forward: block b owns columns 64 (b % slabs) .. +63 of rows
// 64 (b / slabs) .. +63, and sums s W over k in chunks of 64, each chunk of s (lerp of
// agg and h0) and of W staged in shared memory, zero past F.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
gcnii_tiled_fwd_kernel(const float* __restrict__ agg, const float* __restrict__ h0,
                       const float* __restrict__ w, const float* __restrict__ u,
                       float* __restrict__ out, float* __restrict__ s_out,
                       uint8_t* __restrict__ flags, int n, int f, int slabs, float alpha,
                       float beta, float one_m_beta, float keep, float scale) {
  __shared__ __align__(16) float ss[kTileR * kLd];  // a chunk of s [64 rows][64 k]
  __shared__ __align__(16) float ws[kSlab * kSlab];  // a chunk of W [64 k][64 columns]
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int c0 = (int)(blockIdx.x % slabs) * kSlab;
  const int64_t row0 = (int64_t)(blockIdx.x / slabs) * kTileR;
  float acc[kRows][4];
  zero(acc);
  float4 own[kRows];  // s at the block's own columns
  for (int kc = 0; kc < f; kc += kSlab) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = ty + kTY * i;
      const int64_t r = row0 + lr;
      const int col = kc + 4 * tx;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < n && col < f) {
        const int64_t off = r * f + col;
        v = lerp4(ld4(agg + off), ld4(h0 + off), alpha);
        if (kc == c0) st4(s_out + off, v);
      }
      if (kc == c0) own[i] = v;
      st4(ss + lr * kLd + 4 * tx, v);
    }
#pragma unroll
    for (int j = 0; j < kSlab * kSlab / 4 / kThreads; ++j) {
      const int idx = tid + kThreads * j, k = kc + idx / kTX, col = c0 + 4 * (idx % kTX);
      st4(ws + 4 * idx, k < f && col < f ? ld4(w + (int64_t)k * f + col)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    __syncthreads();  // the chunks of s and W are in place
    tile_product<kSlab, kLd, kSlab, kTY>(ss, ws, tx, ty, acc);
    __syncthreads();  // both chunks are read: the next may overwrite them
  }
  const int col = c0 + 4 * tx;
  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = row0 + ty + kTY * i;
    if (r >= n) continue;
    const int64_t off = r * f + col;
    const uint32_t kept = kDrop ? kept4(ld4_stream(u + off), keep) : 0u;
    relu_drop<kDrop>(acc[i], own[i], kept, beta, one_m_beta, scale, out + off, flags + off);
  }
}

// The tiled backward's g_agg and g_h0: as the forward, with g_z (from g and the flags)
// for s and W^T for W.
__global__ void __launch_bounds__(kThreads)
gcnii_tiled_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ flags,
                       const float* __restrict__ w, float* __restrict__ g_agg,
                       float* __restrict__ g_h0, int n, int n_rows, int f, int slabs,
                       float alpha, float one_m_alpha, float beta, float one_m_beta,
                       float scale) {
  __shared__ __align__(16) float gs[kTileR * kLd];   // a chunk of g_z [64 rows][64 k]
  __shared__ __align__(16) float wt[kSlab * kSlab];  // W^T [64 k][64 columns]
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int c0 = (int)(blockIdx.x % slabs) * kSlab;
  const int64_t row0 = (int64_t)(blockIdx.x / slabs) * kTileR;
  if (blockIdx.x == 0) zero_padded_rows(g_agg, n, n_rows, f);
  float acc[kRows][4];
  zero(acc);
  float4 own[kRows];  // g_z at the block's own columns
  for (int kc = 0; kc < f; kc += kSlab) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = ty + kTY * i;
      const int64_t r = row0 + lr;
      const int col = kc + 4 * tx;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < n && col < f)
        v = grad_z4(ld4(g + r * f + col),
                    __ldg(reinterpret_cast<const uchar4*>(flags + r * f + col)), scale);
      if (kc == c0) own[i] = v;
      st4(gs + lr * kLd + 4 * tx, v);
    }
    // wt[k][c] = W[c0 + c][kc + k]: a warp reads 32 rows of W, 4 k each, and writes
    // 32 consecutive columns of wt
#pragma unroll
    for (int j = 0; j < kSlab * kSlab / 4 / kThreads; ++j) {
      const int idx = tid + kThreads * j, c = idx % kSlab, kq = idx / kSlab;
      const int row = c0 + c, k = kc + 4 * kq;
      const float4 v = row < f && k < f ? ld4(w + (int64_t)row * f + k)
                                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      wt[(4 * kq) * kSlab + c] = v.x;
      wt[(4 * kq + 1) * kSlab + c] = v.y;
      wt[(4 * kq + 2) * kSlab + c] = v.z;
      wt[(4 * kq + 3) * kSlab + c] = v.w;
    }
    __syncthreads();  // the chunks of g_z and W^T are in place
    tile_product<kSlab, kLd, kSlab, kTY>(gs, wt, tx, ty, acc);
    __syncthreads();  // both chunks are read: the next may overwrite them
  }
  const int col = c0 + 4 * tx;
  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t r = row0 + ty + kTY * i;
    if (r >= n) continue;
    const int64_t off = r * f + col;
    float d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = fmaf(beta, acc[i][c], one_m_beta * at(own[i], c));
    st4(g_agg + off, make_float4(one_m_alpha * d[0], one_m_alpha * d[1], one_m_alpha * d[2],
                                 one_m_alpha * d[3]));
    st4(g_h0 + off, make_float4(alpha * d[0], alpha * d[1], alpha * d[2], alpha * d[3]));
  }
}

// The tiled backward's dW partials: block b owns dW's rows 64 (p / slabs) .. +63 and
// columns 64 (p % slabs) .. +63, p = b % slabs^2, and the row tiles t = b / slabs^2,
// t + splits, ..., in order; it writes s^T g_z over them to partial[b / slabs^2].
__global__ void __launch_bounds__(kThreads)
gcnii_tiled_dw_kernel(const float* __restrict__ g, const uint8_t* __restrict__ flags,
                      const float* __restrict__ s, float* __restrict__ partial, int n, int f,
                      int slabs, int splits, float scale) {
  __shared__ __align__(16) float ss[kTileR * kLd];  // s [64 rows][dW's 64 rows]
  __shared__ __align__(16) float gs[kTileR * kLd];  // g_z [64 rows][dW's 64 columns]
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int pair = blockIdx.x % (slabs * slabs), split = blockIdx.x / (slabs * slabs);
  const int a0 = pair / slabs * kSlab, b0 = pair % slabs * kSlab;
  const int64_t n_tiles = ((int64_t)n + kTileR - 1) / kTileR;
  float dw[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dw[a][b] = 0.0f;
  for (int64_t tile = split; tile < n_tiles; tile += splits) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = ty + kTY * i;
      const int64_t r = tile * kTileR + lr;
      float4 sv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gv = sv;
      if (r < n && a0 + 4 * tx < f) sv = ld4(s + r * f + a0 + 4 * tx);
      if (r < n && b0 + 4 * tx < f) {
        const int64_t off = r * f + b0 + 4 * tx;
        gv = grad_z4(ld4(g + off), __ldg(reinterpret_cast<const uchar4*>(flags + off)), scale);
      }
      st4(ss + lr * kLd + 4 * tx, sv);
      st4(gs + lr * kLd + 4 * tx, gv);
    }
    __syncthreads();  // the tiles of s and g_z are in place
    outer_sum<kTileR, kLd>(ss, gs, tx, ty, dw);
    __syncthreads();  // both tiles are read: the next may overwrite them
  }
  const int b = b0 + 4 * tx;
  if (b >= f) return;
  float* p = partial + (int64_t)split * f * f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = a0 + 4 * ty + k;
    if (a < f) st4(p + (int64_t)a * f + b, make_float4(dw[k][0], dw[k][1], dw[k][2], dw[k][3]));
  }
}

constexpr int kReduceWarps = 32;

// dW[e] = beta * sum_b partial[b][e], b in order: warp w of a block adds the partials
// b = w, w + 32, .. of its block's 32 entries, then warp 0 adds the 32 sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
gcnii_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int n_part,
                       int ff, float beta) {
  __shared__ float sums[kReduceWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.0f;
  if (e < ff) {
#pragma unroll 4
    for (int b = warp; b < n_part; b += kReduceWarps) sum += __ldcs(partial + (int64_t)b * ff + e);
  }
  sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && e < ff) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) t += sums[i][lane];
    dw[e] = beta * t;
  }
}

// Per-device caches: a kernel's shared-memory limit and the card's block counts are
// set and read once for each device the process launches on.
constexpr int kMaxDevices = 64;

// blocks of `kernel` (with `smem` bytes of dynamic shared memory, its limit set to
// that first) that the current device runs at once; 0 and `*err` set on a failure.
// `cache` holds one count a device.
template <typename K>
int resident_blocks(K kernel, int smem, int (&cache)[kMaxDevices], cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const int blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

template <int F, bool kDrop>
cudaError_t launch_fwd(const void* agg, const void* h0, const void* w, const void* u,
                       void* out, void* s, void* flags, int n, float alpha, float beta,
                       float one_m_beta, float keep, float scale, cudaStream_t stream) {
  auto kernel = gcnii_fused_fwd_kernel<F, kDrop>;
  constexpr int smem = Tile<F>::kFwdSmem;
  static int cache[kMaxDevices];
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(kernel, smem, cache, &err);
  if (resident == 0) return err;
  const int tiles = (n + Tile<F>::R - 1) / Tile<F>::R;
  kernel<<<tiles < resident ? tiles : resident, kThreads, smem, stream>>>(
      static_cast<const float*>(agg), static_cast<const float*>(h0),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(s), static_cast<uint8_t*>(flags), n, alpha, beta, one_m_beta, keep,
      scale);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_tiled_fwd(const void* agg, const void* h0, const void* w, const void* u,
                             void* out, void* s, void* flags, int n, int f, float alpha,
                             float beta, float one_m_beta, float keep, float scale,
                             cudaStream_t stream) {
  const int slabs = (f + kSlab - 1) / kSlab;
  const int64_t blocks = ((int64_t)n + kTileR - 1) / kTileR * slabs;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gcnii_tiled_fwd_kernel<kDrop><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(agg), static_cast<const float*>(h0),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(s), static_cast<uint8_t*>(flags), n, f, slabs, alpha, beta,
      one_m_beta, keep, scale);
  return cudaGetLastError();
}

template <int F>
int bwd_resident(cudaError_t* err) {
  static int cache[kMaxDevices];
  return resident_blocks(gcnii_fused_bwd_kernel<F>, Tile<F>::kBwdSmem, cache, err);
}

// the partials of dW the backward writes at most: for the whole kernels the blocks
// resident on the card, for the tiled the row splits of each 64 x 64 block of dW
int bwd_partials(int f, cudaError_t* err) {
  *err = cudaSuccess;
  if (f == 16) return bwd_resident<16>(err);
  if (f == 32) return bwd_resident<32>(err);
  if (f == 64) return bwd_resident<64>(err);
  if (f <= 0 || f % 4) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  static int cache[kMaxDevices];
  const int resident = resident_blocks(gcnii_tiled_dw_kernel, 0, cache, err);
  if (resident == 0) return 0;
  const int slabs = (f + kSlab - 1) / kSlab;
  const int splits = resident / (slabs * slabs);
  return splits > 0 ? splits : 1;
}

cudaError_t launch_reduce(const void* partial, void* dw, int parts, int f, float beta,
                          cudaStream_t stream) {
  gcnii_dw_reduce_kernel<<<(f * f + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), parts, f * f, beta);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const void* g, const void* flags, const void* s, const void* w,
                       void* g_agg, void* g_h0, void* partial, void* dw, int n, int n_rows,
                       int max_blocks, float alpha, float one_m_alpha, float beta,
                       float one_m_beta, float scale, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const int resident = bwd_resident<F>(&err);
  if (resident == 0) return err;
  const int tiles = (n + Tile<F>::R - 1) / Tile<F>::R;
  int blocks = tiles < resident ? tiles : resident;
  if (blocks > max_blocks) blocks = max_blocks;
  gcnii_fused_bwd_kernel<F><<<blocks, kThreads, Tile<F>::kBwdSmem, stream>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(flags),
      static_cast<const float*>(s), static_cast<const float*>(w), static_cast<float*>(g_agg),
      static_cast<float*>(g_h0), static_cast<float*>(partial), n, n_rows, alpha, one_m_alpha,
      beta, one_m_beta, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, dw, blocks, F, beta, stream);
}

cudaError_t launch_tiled_bwd(const void* g, const void* flags, const void* s, const void* w,
                             void* g_agg, void* g_h0, void* partial, void* dw, int n,
                             int n_rows, int f, int max_blocks, float alpha,
                             float one_m_alpha, float beta, float one_m_beta, float scale,
                             cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const int slabs = (f + kSlab - 1) / kSlab;
  const int64_t tiles = ((int64_t)n + kTileR - 1) / kTileR;
  if (tiles * slabs > 0x7fffffff) return cudaErrorInvalidValue;
  gcnii_tiled_bwd_kernel<<<(int)(tiles * slabs), kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(flags),
      static_cast<const float*>(w), static_cast<float*>(g_agg), static_cast<float*>(g_h0), n,
      n_rows, f, slabs, alpha, one_m_alpha, beta, one_m_beta, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int splits = bwd_partials(f, &err);
  if (splits == 0) return err;
  if (splits > max_blocks) splits = max_blocks;
  if (splits > tiles) splits = (int)tiles;
  gcnii_tiled_dw_kernel<<<splits * slabs * slabs, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(flags),
      static_cast<const float*>(s), static_cast<float*>(partial), n, f, slabs, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, dw, splits, f, beta, stream);
}

}  // namespace

extern "C" {

// The forward over n rows of width f (any multiple of 4). agg is K1's output (its
// rows from n on are not read), h0, out and s are float32 [n, f], w float32 [f, f],
// flags bytes [n, f]; u float32 [n, f], or null for no dropout (keep and scale
// unread). All pointers 16-byte aligned, rows contiguous. Launches one kernel on
// `stream` and returns cudaGetLastError() after it; nothing is launched when a check
// fails.
int dgll_gcnii_fused_fwd(const void* agg, const void* h0, const void* w, const void* u,
                         void* out, void* s, void* flags, int n, int f, float alpha,
                         float beta, float one_m_beta, float keep, float scale,
                         void* stream) {
  if (n <= 0 || f <= 0 || f % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGLL_GCNII_FWD(F)                                                                  \
  if (f == F)                                                                             \
    return u ? launch_fwd<F, true>(agg, h0, w, u, out, s, flags, n, alpha, beta,          \
                                   one_m_beta, keep, scale, st)                           \
             : launch_fwd<F, false>(agg, h0, w, u, out, s, flags, n, alpha, beta,         \
                                    one_m_beta, keep, scale, st);
  DGLL_GCNII_FWD(16)
  DGLL_GCNII_FWD(32)
  DGLL_GCNII_FWD(64)
#undef DGLL_GCNII_FWD
  return u ? launch_tiled_fwd<true>(agg, h0, w, u, out, s, flags, n, f, alpha, beta,
                                    one_m_beta, keep, scale, st)
           : launch_tiled_fwd<false>(agg, h0, w, u, out, s, flags, n, f, alpha, beta,
                                     one_m_beta, keep, scale, st);
}

// The partials the backward writes at most on the current device, or a negative
// CUDA error code.
int dgll_gcnii_fused_bwd_blocks(int f) {
  cudaError_t err = cudaSuccess;
  const int blocks = bwd_partials(f, &err);
  return blocks > 0 ? blocks : -static_cast<int>(err == cudaSuccess ? cudaErrorInvalidValue
                                                                     : err);
}

// The backward: g (the gradient of out), s float32 [n, f], flags bytes [n, f], w
// float32 [f, f]; writes g_agg float32 [n_rows, f] (rows n .. n_rows-1 zero), g_h0
// float32 [n, f] and dw float32 [f, f], through partial, float32 scratch of
// max_blocks x f x f. scale is 1 / keep, or 1 without dropout. Launches the backward
// (and for a tiled width its dW kernel) and the partials' sum on `stream`; returns
// cudaGetLastError() after them; nothing is launched when a check fails.
int dgll_gcnii_fused_bwd(const void* g, const void* flags, const void* s, const void* w,
                         void* g_agg, void* g_h0, void* partial, void* dw, int n, int n_rows,
                         int f, int max_blocks, float alpha, float one_m_alpha, float beta,
                         float one_m_beta, float scale, void* stream) {
  if (n <= 0 || n_rows < n || max_blocks <= 0 || f <= 0 || f % 4)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGLL_GCNII_BWD(F)                                                                  \
  if (f == F)                                                                             \
    return launch_bwd<F>(g, flags, s, w, g_agg, g_h0, partial, dw, n, n_rows, max_blocks, \
                         alpha, one_m_alpha, beta, one_m_beta, scale, st);
  DGLL_GCNII_BWD(16)
  DGLL_GCNII_BWD(32)
  DGLL_GCNII_BWD(64)
#undef DGLL_GCNII_BWD
  return launch_tiled_bwd(g, flags, s, w, g_agg, g_h0, partial, dw, n, n_rows, f, max_blocks,
                          alpha, one_m_alpha, beta, one_m_beta, scale, st);
}

}  // extern "C"
