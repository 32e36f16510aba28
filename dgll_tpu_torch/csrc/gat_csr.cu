// GAT attention kernels over the dst-major CSR, for Hopper (sm_90a).
//
// The kernels of the fused GAT layer (ops/cuda/gat_fused.py) and of the round-4
// attention path (ops/gat.py, ops/edge_ops.py), all float32 but K7, which also
// copies bfloat16 rows. Per-edge arrays are
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
//   K6' rows_to_edges_multi: out[e,h] = v[r,h]; K10 rows_to_edges the same at H = 1.
//   K7 expand_rows:      out[e,:] = a[r,:], float32 or bfloat16 (a copy).
//   K9 sddmm:            out[e] = <a[r,:], msg[e,:]>.
//
// They replace the TPU kernels _stats_kernel, _alpha_kernel and _bwd_sm_kernel
// (dgll_tpu/ops/pallas/gat_fused.py), _e2r_multi_kernel (dgll_tpu/ops/pallas/
// edge_ops.py; its sum, sum_all and max modes), _r2e_multi_kernel (edge_ops.py, K6'),
// _rows_to_edges_kernel (edge_ops.py, K10), _expand_kernel (dgll_tpu/ops/pallas/
// expand_rows.py) and _sddmm_kernel (dgll_tpu/ops/pallas/sddmm.py). Those walk
// 128-row blocks of edge chunks in grid order, carry running sums from chunk to
// chunk in scratch memory, and move values between rows and edges
// with one-hot matrix products (the TPU has no gather or atomics). Here each row (or
// segment of a long row, which a second pass combines) is one warp's or one lane
// group's, so nothing carries between blocks, and rows and edges meet through the
// CSR's indptr and row ids.
//
// One more TPU kernel needs no kernel of its own: the single-head _reduce_kernel
// (K10) computes what K6 computes at H = 1. Its sum_all mode, which also sums the TPU
// layout's padding slots, is the sum mode here: this layout has no padding slots.
// Its wrapper (ops/cuda/edge_ops.py) launches K6 and counts the launches apart.
//
// Design of the row reductions K3, K5 and K6: work items of at most max_edges edges,
// as in K1 (csrc/segment_matmul.cu), one lane group each.
//
// * Rows of at most max_edges edges are one item each and write their outputs
//   directly. A longer row (a hub of a power-law graph: 53,866 in-edges on the CLI
//   graph) is cut into segments by the layout's split schedule, the one K1 runs on
//   (ops/chunked.py:split_schedule, built once per layout from indptr alone). Pass 1
//   writes each segment's per-head partials into f32 scratch [n_seg, H] that the
//   caller allocates; pass 2, one thread a (split row, head), combines a row's
//   partials in segment order. Both passes run on the caller's stream in one C call,
//   so nothing reads a split row's output between them. Segments come first in pass
//   1's grid, so the hub work starts first. A segment finds its destination row as
//   the row of its first edge (rows[beg]).
// * K3 takes two passes over an item, the max and then the sum of exp(e - max), so
//   a row's m is exact (equal to the plain version's) and an unsplit row's den is the
//   plain two-pass sum. A segment writes (m_seg, den_seg = sum exp(e - m_seg)); pass
//   2 takes m = max m_seg and den = sum den_seg * exp(m_seg - m), the rescaling by
//   which the JAX kernel combines its chunks (gat_fused.py:82-89); exp(m_seg - m) is
//   exactly 1 for the segment that holds the maximum. K5 writes every edge's dz in
//   pass 1 and a segment's partial row sum; pass 2 adds the partials.
// * K6 reads its one array once an item. A segment writes its per-head sum or max;
//   pass 2 adds the sums in segment order, or takes the max of the maxima (exact, as
//   K3's m). One pass-1 and one pass-2 kernel, templated on the reduction, serve K6's
//   sum and max; K5's pass 2 is the sum instance.
// * Heads across lanes, for H a power of two up to 32 (the wrapper says which): a
//   row's per-edge values are one contiguous block x[beg*H .. end*H), which a group
//   of G lanes reads G floats at a time, coalesced. Lane j always holds head j % H (G
//   is a multiple of H) and edges beg + j / H, + G / H, ...; the lanes of one head
//   meet in log2(G / H) xor-shuffles (2 a pass at H = 8 and G = 32, where a loop over
//   heads takes 5 a head), and lanes 0..H-1 write the item's H outputs side by side.
//   The wrapper takes G = 8 H up to a warp (ops/cuda/gat_fused.py:item_lanes): at
//   H = 1 a warp then holds 4 short rows at a time, which measured faster than one
//   row a warp on an H100 on the CLI graph, whose rows average 27 edges; at H = 8 a
//   whole warp, which K3 needs (it measured slower on 8 or 16 lanes). Any other H
//   (3, 6, above 32) takes a warp an item and one pass a head: lanes over edges, a
//   stride of H floats, the whole warp's 5 shuffles.
// * A row's s_dst (K3) or S (K5) is loaded once a lane, issued beside the row's
//   indptr loads: its index is known before them.
//
// Every row's outputs are written, rows without edges included (K6 writes 0 or
// -3e38), and no kernel uses atomics: each sum has a fixed order (edge order within a
// lane, the shuffle tree, segment order), so results are bitwise repeatable. K7 is a
// grid-stride loop over the flat [nnz * F] index. K9 is per edge too: every edge's
// dot product is independent, so a group of
// a few lanes (a power of two, up to 32, no more than the row's float4 count) owns
// one edge, reads its msg row and a[r] (through the read-only cache: a is small and
// its rows repeat along a row's edges) in float4 units, and finishes with a shuffle
// reduction inside the group. Parallel over edges, it has no hub-row tail.
//
// Design of K4, K6' and K10's rows-to-edges, which carry per-row values [n_rows, H]
// out to the edges [nnz, H] through rows (K4 with its arithmetic, K6' and K10 as a
// copy): one edge-major mapping, written once (edges_heads4_kernel, edges_quads_kernel,
// edges_one_kernel below), templated on what a unit computes. A unit is a float4 of
// per-edge values where the pointers allow it; consecutive threads take consecutive
// units, so a warp's loads and stores of per-edge values are 512 contiguous bytes,
// and the grid strides over them. The wrapper (ops/cuda/gat_fused.py:edge_plan) picks
// the variant and a grid of one thread a unit: on an H100 at the GAT slice's shapes
// that was fastest, or within 2% of grids of 1-4 waves; runs of 2 or 4 consecutive
// units a thread were 1.6-2.7x slower (their lanes' 16-byte accesses 32 or 64 bytes
// apart, and a unit's loads waiting on the last unit's stores), and two units a grid
// apart with every load issued first gained K6' 5% and lost K4 2%. The variants:
// * 4 heads a unit (H % 4 == 0; per-edge and per-row arrays 16-byte aligned): unit
//   u = e * G + j holds heads 4j .. 4j+3 of edge e, G = H / 4. The per-row values are
//   read as float4 at [rows[e] * G + j] through the read-only path (consecutive edges
//   of a dst-sorted CSR mostly share a row, so these hit L1/L2). The kernel is
//   templated on log2 G for H = 4 .. 64, so the edge index is a shift; any other G
//   divides once a unit (4 values).
// * 4 edges a unit (H = 1; rows and per-edge arrays 16-byte aligned): one int4 of row
//   ids, four scalar gathers of each per-row value, float4 loads and stores along the
//   edges; threads 0 .. nnz % 4 - 1 of block 0 take the last edges.
// * one edge a unit (any other H, or a misaligned pointer): a loop over the heads.
// A thread loads its unit's row ids once; for G a power of two up to 16 the loop
// holds no 64-bit division or modulo. The old K4, one thread a value behind a 64-bit division by H,
// paid dozens of instructions a value and moved 4 bytes an access, so instructions,
// not bytes, set its pace; K6' ran on K7's kernel, a 64-bit division and a load of
// rows[e] per float4. K4 keeps the reference's full float32 (expf and IEEE division).
//
// What bounds them: memory bytes, a few float32 values per edge and head. K4, K6',
// K7 and K9 stream their per-edge arrays once; K5 reads three and writes one. K3 reads
// its one array twice, the second time mostly from L1/L2; the latency of a short
// item's dependent loads (indptr, then its values, then the second pass) holds it
// further from its bound than K5, and it needs every warp an SM can hold: keeping a
// lane's values in registers between the passes (64 registers, half the warps) and
// asking for 8 blocks an SM (32 registers, spills) both measured slower. K6, with one
// read an item and nothing to write per edge, is the most latency-bound of the three:
// an item's indptr loads, then its values, then the shuffles.
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
constexpr unsigned kFull = 0xffffffffu;

// Max and sum over the lanes l ^ (span << k) of a group of `group` lanes (powers of
// two, span <= group <= 32): xor-shuffles with offsets group / 2 down to span; span 1
// and group 32 reduce the whole warp.
__device__ __forceinline__ float lanes_max(float v, int span, int group) {
  for (int o = group >> 1; o >= span; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float lanes_sum(float v, int span, int group) {
  for (int o = group >> 1; o >= span; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

// The split schedule of K3 and K5 (ops/chunked.py:SplitSchedule): segments
// [seg_beg, seg_end) of the n_split rows split_row with more than max_edges edges,
// split_ptr their ranges of segments.
struct Split {
  const int* seg_beg;
  const int* seg_end;
  const int* split_row;
  const int* split_ptr;
  int n_seg, n_split, max_edges;
};

// A warp's lanes in pass 1 of K3 and K5: groups of `group` lanes (a power of two;
// 32 unless heads across lanes), one work item a group, and how a group covers its
// item's [deg, H] block x[beg*H .. end*H). With heads across lanes, one pass in
// which group lane j reads flat indices beg*H + j, + group, ... (head j % H; group is
// a multiple of H); otherwise one pass a head h, lane j on (beg + j)*H + h, + 32*H,
// ... The lanes of one head are j ^ (span << k), and group lanes [0, span) write.
struct Lanes {
  bool across;
  int heads, group, passes, span, stride;
  __device__ Lanes(int heads_, int across_, int group_)
      : across(across_ != 0), heads(heads_), group(group_), passes(across ? 1 : heads_),
        span(across ? heads_ : 1), stride(across ? group_ : 32 * heads_) {}
  __device__ int head(int j, int pass) const { return across ? j & (heads - 1) : pass; }
  __device__ int64_t first(int beg, int j, int pass) const {
    return across ? (int64_t)beg * heads + j : (int64_t)(beg + j) * heads + pass;
  }
};

// Pass 1's work item of a lane group: [0, n_seg) are the segments, then the rows.
struct Item {
  int index;     // segment index, or n_seg + row
  int j;         // this thread's lane in its group
  int row;       // destination row; n_rows for an item past the last
  int beg, end;  // edges
  bool segment;
};

// The item of this thread's lane group. A row's index is known before its indptr
// loads return, so the kernels issue the load of its per-row value (s_dst, S) beside
// them, before they look at its degree (`active`).
__device__ __forceinline__ Item item_of(const Lanes& ln, int n_rows,
                                        const int* __restrict__ indptr,
                                        const int* __restrict__ rows, const Split& sp) {
  const int lane = threadIdx.x & 31;
  Item it;
  it.index = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / ln.group) +
             lane / ln.group;
  it.j = lane & (ln.group - 1);
  it.segment = it.index < sp.n_seg;
  it.beg = it.end = 0;
  if (it.segment) {
    it.beg = sp.seg_beg[it.index];
    it.end = sp.seg_end[it.index];
    it.row = rows[it.beg];
    return it;
  }
  it.row = min(it.index - sp.n_seg, n_rows);
  if (it.row < n_rows) {
    it.beg = indptr[it.row];
    it.end = indptr[it.row + 1];
  }
  return it;
}

// Whether the item reads its edges: a segment, or a row of at most max_edges edges
// (a longer row's segments cover it). An inactive group reads nothing and writes
// nothing, but takes part in its warp's shuffles.
__device__ __forceinline__ bool active(Item& it, int n_rows, const Split& sp) {
  const bool a = it.segment || (it.row < n_rows && it.end - it.beg <= sp.max_edges);
  if (!a) it.end = it.beg;
  return a;
}

// K3, pass 1: an item's per-head max and sum of exponentials, into m and den for a
// row, into m_seg and den_seg for a segment.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_stats_kernel(const int* __restrict__ indptr, const int* __restrict__ rows,
                 const float* __restrict__ sc_src, const float* __restrict__ s_dst,
                 float* __restrict__ m, float* __restrict__ den,
                 float* __restrict__ m_seg, float* __restrict__ den_seg, Split sp,
                 int n_rows, int heads, int across, int group, float slope) {
  const Lanes ln(heads, across, group);
  Item it = item_of(ln, n_rows, indptr, rows, sp);
  const int64_t row_h = (int64_t)min(it.row, n_rows - 1) * heads;
  float sd = s_dst[row_h + ln.head(it.j, 0)];
  const bool writes = active(it, n_rows, sp);
  if (!__any_sync(kFull, writes)) return;  // the same for the whole warp
  const int64_t hi = (int64_t)it.end * heads;
  for (int pass = 0; pass < ln.passes; ++pass) {
    const int h = ln.head(it.j, pass);
    if (pass > 0) sd = s_dst[row_h + h];
    const int64_t lo = ln.first(it.beg, it.j, pass);
    float mx = kNeg;
#pragma unroll 4
    for (int64_t i = lo; i < hi; i += ln.stride)
      mx = fmaxf(mx, leaky(sc_src[i] + sd, slope));
    mx = lanes_max(mx, ln.span, ln.group);
    float s = 0.f;
#pragma unroll 4
    for (int64_t i = lo; i < hi; i += ln.stride)
      s += expf(leaky(sc_src[i] + sd, slope) - mx);
    s = lanes_sum(s, ln.span, ln.group);
    if (writes && it.j < ln.span) {
      const int64_t o = (int64_t)(it.segment ? it.index : it.row) * heads + h;
      (it.segment ? m_seg : m)[o] = mx;
      (it.segment ? den_seg : den)[o] = s;
    }
  }
}

// K3, pass 2: thread t is head t % H of split row t / H: the maximum of the row's
// segment maxima, then the segments' sums rescaled to it, added in segment order.
__global__ void __launch_bounds__(kThreads)
gat_stats_combine_kernel(const float* __restrict__ m_seg,
                         const float* __restrict__ den_seg, float* __restrict__ m,
                         float* __restrict__ den, Split sp, int heads) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)sp.n_split * heads) return;
  const int r = (int)(t / heads);
  const int h = (int)(t - (int64_t)r * heads);
  const int p0 = sp.split_ptr[r], p1 = sp.split_ptr[r + 1];
  float mx = kNeg;
  for (int p = p0; p < p1; ++p) mx = fmaxf(mx, m_seg[(int64_t)p * heads + h]);
  float s = 0.f;
  for (int p = p0; p < p1; ++p) {
    const int64_t i = (int64_t)p * heads + h;
    s += den_seg[i] * expf(m_seg[i] - mx);
  }
  const int64_t o = (int64_t)sp.split_row[r] * heads + h;
  m[o] = mx;
  den[o] = s;
}

// ---- The edge-major mapping of K4, K6' and K10's rows-to-edges ----------------------
//
// An Op computes the outputs of the values it is given: one(i, d) the value of
// per-edge flat index i, whose row's values are at per-row flat index d; quad(q, r)
// edges 4q .. 4q+3 at H = 1 (per-edge float4 index q), whose rows are r; heads4(u, d)
// heads 4j .. 4j+3 of an edge (per-edge float4 index u), its row's at float4 index d.

__device__ __forceinline__ float4 ldg4(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ float4 ld4(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ void st4(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// A thread's first unit, and the grid's stride over the units.
__device__ __forceinline__ int64_t first_unit() {
  return blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t unit_stride() { return (int64_t)gridDim.x * blockDim.x; }

// 4 heads a unit: unit u = e * G + j is heads 4j .. 4j+3 of edge e. LG = log2 G, or
// -1 for a G known at run time, which is divided by once a unit.
template <int LG, typename Op>
__global__ void __launch_bounds__(kThreads)
edges_heads4_kernel(Op op, const int* __restrict__ rows, int64_t nnz, int groups) {
  const int g = LG >= 0 ? 1 << LG : groups;
  const int64_t units = nnz * g;
  for (int64_t u = first_unit(); u < units; u += unit_stride()) {
    const int64_t e = LG >= 0 ? u >> LG : u / g;
    op.heads4(u, (int64_t)__ldg(rows + e) * g + (u - e * g));
  }
}

// 4 edges a unit at H = 1 (rows 16-byte aligned); block 0 takes the last nnz % 4.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
edges_quads_kernel(Op op, const int* __restrict__ rows, int64_t nnz) {
  const int64_t quads = nnz >> 2;
  for (int64_t q = first_unit(); q < quads; q += unit_stride())
    op.quad(q, __ldg(reinterpret_cast<const int4*>(rows) + q));
  if (blockIdx.x == 0 && threadIdx.x < (nnz & 3)) {
    const int64_t e = (quads << 2) + threadIdx.x;
    op.one(e, __ldg(rows + e));
  }
}

// One edge a unit, a loop over its heads.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
edges_one_kernel(Op op, const int* __restrict__ rows, int64_t nnz, int heads) {
  for (int64_t e = first_unit(); e < nnz; e += unit_stride()) {
    const int64_t d = (int64_t)__ldg(rows + e) * heads;
    for (int h = 0; h < heads; ++h) op.one(e * heads + h, d + h);
  }
}

// K4 for one (edge, head): its score z = sc + s_dst[r], alpha and the LeakyReLU slope
// factor, with the reference's expf and IEEE division.
__device__ __forceinline__ void alpha_of(float sc, float sd, float m, float den,
                                         float slope, float& alpha, float& lgrad) {
  const float z = sc + sd;
  alpha = expf(fminf(leaky(z, slope) - m, 0.f)) * (1.f / fmaxf(den, 1e-16f));
  lgrad = z > 0.f ? 1.f : slope;
}

struct AlphaOp {
  const float* sc_src;
  const float* s_dst;
  const float* m;
  const float* den;
  float* alpha;
  float* lgrad;
  float slope;

  __device__ void one(int64_t i, int64_t d) const {
    alpha_of(sc_src[i], __ldg(s_dst + d), __ldg(m + d), __ldg(den + d), slope, alpha[i],
             lgrad[i]);
  }
  __device__ void quad(int64_t q, int4 r) const {
    const float4 sc = ld4(sc_src, q);
    float4 a, l;
    alpha_of(sc.x, __ldg(s_dst + r.x), __ldg(m + r.x), __ldg(den + r.x), slope, a.x, l.x);
    alpha_of(sc.y, __ldg(s_dst + r.y), __ldg(m + r.y), __ldg(den + r.y), slope, a.y, l.y);
    alpha_of(sc.z, __ldg(s_dst + r.z), __ldg(m + r.z), __ldg(den + r.z), slope, a.z, l.z);
    alpha_of(sc.w, __ldg(s_dst + r.w), __ldg(m + r.w), __ldg(den + r.w), slope, a.w, l.w);
    st4(alpha, q, a);
    st4(lgrad, q, l);
  }
  __device__ void heads4(int64_t u, int64_t d) const {
    const float4 sc = ld4(sc_src, u), sd = ldg4(s_dst, d), mx = ldg4(m, d),
                 dn = ldg4(den, d);
    float4 a, l;
    alpha_of(sc.x, sd.x, mx.x, dn.x, slope, a.x, l.x);
    alpha_of(sc.y, sd.y, mx.y, dn.y, slope, a.y, l.y);
    alpha_of(sc.z, sd.z, mx.z, dn.z, slope, a.z, l.z);
    alpha_of(sc.w, sd.w, mx.w, dn.w, slope, a.w, l.w);
    st4(alpha, u, a);
    st4(lgrad, u, l);
  }
};

// K6' and K10's rows-to-edges: out[e, h] = v[rows[e], h].
struct GatherOp {
  const float* v;
  float* out;

  __device__ void one(int64_t i, int64_t d) const { out[i] = __ldg(v + d); }
  __device__ void quad(int64_t q, int4 r) const {
    st4(out, q,
        make_float4(__ldg(v + r.x), __ldg(v + r.y), __ldg(v + r.z), __ldg(v + r.w)));
  }
  __device__ void heads4(int64_t u, int64_t d) const { st4(out, u, ldg4(v, d)); }
};

// The reductions of K6 and of the sum or max combine of pass 2: an identity, a
// combine, and the reduction over the lanes of one head in a lane group (lanes_sum,
// lanes_max).
struct SumOp {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float b) { return a + b; }
  static __device__ __forceinline__ float lanes(float v, int span, int group) {
    return lanes_sum(v, span, group);
  }
};

struct MaxOp {
  static __device__ __forceinline__ float init() { return kNeg; }
  static __device__ __forceinline__ float combine(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float lanes(float v, int span, int group) {
    return lanes_max(v, span, group);
  }
};

// K6, pass 1: an item's per-head sum or max, into out for a row (the identity for a
// row without edges), into partial for a segment.
template <typename Op>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edges_to_rows_kernel(const int* __restrict__ indptr, const int* __restrict__ rows,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ partial, Split sp, int n_rows, int heads,
                     int across, int group) {
  const Lanes ln(heads, across, group);
  Item it = item_of(ln, n_rows, indptr, rows, sp);
  const bool writes = active(it, n_rows, sp);
  if (!__any_sync(kFull, writes)) return;  // the same for the whole warp
  const int64_t hi = (int64_t)it.end * heads;
  for (int pass = 0; pass < ln.passes; ++pass) {
    float s = Op::init();
#pragma unroll 4
    for (int64_t i = ln.first(it.beg, it.j, pass); i < hi; i += ln.stride)
      s = Op::combine(s, v[i]);
    s = Op::lanes(s, ln.span, ln.group);
    if (writes && it.j < ln.span) {
      const int64_t o =
          (int64_t)(it.segment ? it.index : it.row) * heads + ln.head(it.j, pass);
      (it.segment ? partial : out)[o] = s;
    }
  }
}

// K5, pass 1: an item's dz, and its per-head sum into dsd for a row, into partial
// for a segment.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_softmax_kernel(const int* __restrict__ indptr, const int* __restrict__ rows,
                       const float* __restrict__ alpha, const float* __restrict__ dalpha,
                       const float* __restrict__ lgrad, const float* __restrict__ s_row,
                       float* __restrict__ dz, float* __restrict__ dsd,
                       float* __restrict__ partial, Split sp, int n_rows, int heads,
                       int across, int group) {
  const Lanes ln(heads, across, group);
  Item it = item_of(ln, n_rows, indptr, rows, sp);
  const int64_t row_h = (int64_t)min(it.row, n_rows - 1) * heads;
  float sr = s_row[row_h + ln.head(it.j, 0)];
  const bool writes = active(it, n_rows, sp);
  if (!__any_sync(kFull, writes)) return;  // the same for the whole warp
  const int64_t hi = (int64_t)it.end * heads;
  for (int pass = 0; pass < ln.passes; ++pass) {
    const int h = ln.head(it.j, pass);
    if (pass > 0) sr = s_row[row_h + h];
    float s = 0.f;
#pragma unroll 4
    for (int64_t i = ln.first(it.beg, it.j, pass); i < hi; i += ln.stride) {
      const float v = alpha[i] * (dalpha[i] - sr) * lgrad[i];
      dz[i] = v;
      s += v;
    }
    s = lanes_sum(s, ln.span, ln.group);
    if (writes && it.j < ln.span) {
      const int64_t o = (int64_t)(it.segment ? it.index : it.row) * heads + h;
      (it.segment ? partial : dsd)[o] = s;
    }
  }
}

// Pass 2 of K5 (sum) and K6 (sum, max): thread t is head t % H of split row t / H:
// the row's partials combined in segment order.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
combine_segments_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        Split sp, int heads) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= (int64_t)sp.n_split * heads) return;
  const int r = (int)(t / heads);
  const int h = (int)(t - (int64_t)r * heads);
  float s = Op::init();
  const int p0 = sp.split_ptr[r], p1 = sp.split_ptr[r + 1];
  for (int p = p0; p < p1; ++p) s = Op::combine(s, partial[(int64_t)p * heads + h]);
  out[(int64_t)sp.split_row[r] * heads + h] = s;
}

// T is the unit copied: a 4-byte float, a 2-byte bfloat16 (as uint16_t) or 16 bytes
// (uint4: 4 floats or 8 bfloat16); fv = the units of a row. A copy, so the result is
// bitwise the source row whatever the element type.
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

int stride_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxStrideBlocks ? b : kMaxStrideBlocks);
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <typename... P>
bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

// Launches the edge-major mapping of `op` over [nnz, H] per-edge values in the
// wrapper's variant (ops/cuda/gat_fused.py:edge_plan): vec = 4 takes float4 units,
// 4 heads of an edge (H % 4 == 0) or at H = 1 4 edges, and needs `vectors` (16-byte
// aligned, checked by the caller) and, at H = 1, rows 16-byte aligned; vec = 1 an edge
// a unit. `grid` blocks stride over the units.
template <typename Op>
int launch_edges(const Op& op, bool vectors, const void* rows_, long long nnz, int heads,
                 int vec, int grid, void* stream) {
  const int* rows = static_cast<const int*>(rows_);
  if (nnz < 0 || heads <= 0 || grid <= 0 || (vec != 1 && vec != 4))
    return cudaErrorInvalidValue;
  if (vec == 4 && (!vectors || (heads == 1 ? !aligned16(rows) : heads % 4 != 0)))
    return cudaErrorInvalidValue;
  if (nnz == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 1) {
    edges_one_kernel<<<grid, kThreads, 0, s>>>(op, rows, nnz, heads);
  } else if (heads == 1) {
    edges_quads_kernel<<<grid, kThreads, 0, s>>>(op, rows, nnz);
  } else {
    const int g = heads / 4;
    auto heads4 = g == 1   ? edges_heads4_kernel<0, Op>
                  : g == 2 ? edges_heads4_kernel<1, Op>
                  : g == 4 ? edges_heads4_kernel<2, Op>
                  : g == 8 ? edges_heads4_kernel<3, Op>
                  : g == 16 ? edges_heads4_kernel<4, Op>
                            : edges_heads4_kernel<-1, Op>;
    heads4<<<grid, kThreads, 0, s>>>(op, rows, nnz, g);
  }
  return cudaGetLastError();
}

// The checks K3 and K5 share: sizes; lane groups of a power of two up to 32 lanes,
// which are whole warps unless heads lie across lanes, and then hold whole heads (H
// a power of two); a schedule whose segments and split rows come together.
bool split_args_ok(int n_rows, int heads, int across, int group, int n_seg, int n_split,
                   int max_edges) {
  return n_rows > 0 && heads > 0 && pow2(group) && group <= 32 &&
         (across ? pow2(heads) && heads <= group : group == 32) && n_seg >= 0 &&
         n_split >= 0 && (n_seg > 0) == (n_split > 0) && max_edges > 0;
}

// Pass 1's grid: a lane group per segment and per row.
int item_blocks(const Split& sp, int n_rows, int group) {
  const int64_t per_block = kWarpsPerBlock * (32 / group);
  return (int)(((int64_t)sp.n_seg + n_rows + per_block - 1) / per_block);
}

// Pass 2's grid: a thread per (split row, head).
int combine_blocks(const Split& sp, int heads) {
  return (int)(((int64_t)sp.n_split * heads + kThreads - 1) / kThreads);
}

Split make_split(const void* seg_beg, const void* seg_end, const void* split_row,
                 const void* split_ptr, int n_seg, int n_split, int max_edges) {
  return Split{static_cast<const int*>(seg_beg), static_cast<const int*>(seg_end),
               static_cast<const int*>(split_row), static_cast<const int*>(split_ptr),
               n_seg, n_split, max_edges};
}

template <typename Op>
int edges_to_rows(const void* indptr, const void* rows, const void* v, void* out,
                  int n_rows, int heads, int across, int group, const void* seg_beg,
                  const void* seg_end, const void* split_row, const void* split_ptr,
                  void* partial, int n_seg, int n_split, int max_edges, void* stream) {
  if (!split_args_ok(n_rows, heads, across, group, n_seg, n_split, max_edges) ||
      (n_seg > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Split sp =
      make_split(seg_beg, seg_end, split_row, split_ptr, n_seg, n_split, max_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edges_to_rows_kernel<Op><<<item_blocks(sp, n_rows, group), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(rows),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(partial),
      sp, n_rows, heads, across, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  combine_segments_kernel<Op><<<combine_blocks(sp, heads), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), sp, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t expand_rows(const void* rows, const void* a, void* out, int64_t n, int fv,
                        cudaStream_t s) {
  expand_rows_kernel<T><<<stride_blocks(n), kThreads, 0, s>>>(
      static_cast<const int*>(rows), static_cast<const T*>(a), static_cast<T*>(out), n,
      fv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch, or cudaErrorInvalidValue (and
// launches nothing) for a bad size. All pointers are float32 or int32 device memory,
// but K7's a and out, which may be bfloat16.

// K3, K5 and K6 take the layout's rows ([nnz] int32, each edge's destination row), a
// lane mapping (across = 1: heads across lanes, for H a power of two up to 32; 0:
// one pass a head), the lanes of a work item (group: a power of two, H to 32 with
// heads across lanes, else 32) and the split schedule (ops/chunked.py:
// split_schedule): n_seg segments [seg_beg, seg_end) of the n_split rows split_row
// with more than max_edges edges, split_ptr their segment ranges, with float32
// [n_seg, H] scratch (null when n_seg is 0). They launch pass 1 and, if a row is
// split, pass 2.
int dgll_gat_stats(const void* indptr, const void* rows, const void* sc_src,
                   const void* s_dst, void* m, void* den, int n_rows, int heads,
                   int across, int group, float slope, const void* seg_beg,
                   const void* seg_end, const void* split_row, const void* split_ptr,
                   void* m_seg, void* den_seg, int n_seg, int n_split, int max_edges,
                   void* stream) {
  if (!split_args_ok(n_rows, heads, across, group, n_seg, n_split, max_edges) ||
      (n_seg > 0 && (m_seg == nullptr || den_seg == nullptr)))
    return cudaErrorInvalidValue;
  const Split sp =
      make_split(seg_beg, seg_end, split_row, split_ptr, n_seg, n_split, max_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gat_stats_kernel<<<item_blocks(sp, n_rows, group), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(rows),
      static_cast<const float*>(sc_src), static_cast<const float*>(s_dst),
      static_cast<float*>(m), static_cast<float*>(den), static_cast<float*>(m_seg),
      static_cast<float*>(den_seg), sp, n_rows, heads, across, group, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  gat_stats_combine_kernel<<<combine_blocks(sp, heads), kThreads, 0, s>>>(
      static_cast<const float*>(m_seg), static_cast<const float*>(den_seg),
      static_cast<float*>(m), static_cast<float*>(den), sp, heads);
  return cudaGetLastError();
}

// K4, K6' and K10's rows-to-edges take the edge-major mapping's variant (vec, grid;
// see launch_edges): vec = 4 needs their per-edge arrays and, for H > 1, their
// per-row arrays 16-byte aligned.
int dgll_gat_alpha(const void* rows, const void* sc_src, const void* s_dst, const void* m,
                   const void* den, void* alpha, void* lgrad, long long nnz, int heads,
                   float slope, int vec, int grid, void* stream) {
  const AlphaOp op{static_cast<const float*>(sc_src), static_cast<const float*>(s_dst),
                   static_cast<const float*>(m), static_cast<const float*>(den),
                   static_cast<float*>(alpha), static_cast<float*>(lgrad), slope};
  const bool vectors = aligned16(op.sc_src, op.alpha, op.lgrad) &&
                       (heads == 1 || aligned16(op.s_dst, op.m, op.den));
  return launch_edges(op, vectors, rows, nnz, heads, vec, grid, stream);
}

int dgll_rows_to_edges_multi(const void* rows, const void* v, void* out, long long nnz,
                             int heads, int vec, int grid, void* stream) {
  const GatherOp op{static_cast<const float*>(v), static_cast<float*>(out)};
  const bool vectors = aligned16(op.out) && (heads == 1 || aligned16(op.v));
  return launch_edges(op, vectors, rows, nnz, heads, vec, grid, stream);
}

// K6 takes float32 [n_seg, H] scratch partial (null when n_seg is 0).
int dgll_edges_to_rows_sum(const void* indptr, const void* rows, const void* v, void* out,
                           int n_rows, int heads, int across, int group,
                           const void* seg_beg, const void* seg_end, const void* split_row,
                           const void* split_ptr, void* partial, int n_seg, int n_split,
                           int max_edges, void* stream) {
  return edges_to_rows<SumOp>(indptr, rows, v, out, n_rows, heads, across, group, seg_beg,
                              seg_end, split_row, split_ptr, partial, n_seg, n_split,
                              max_edges, stream);
}

int dgll_edges_to_rows_max(const void* indptr, const void* rows, const void* v, void* out,
                           int n_rows, int heads, int across, int group,
                           const void* seg_beg, const void* seg_end, const void* split_row,
                           const void* split_ptr, void* partial, int n_seg, int n_split,
                           int max_edges, void* stream) {
  return edges_to_rows<MaxOp>(indptr, rows, v, out, n_rows, heads, across, group, seg_beg,
                              seg_end, split_row, split_ptr, partial, n_seg, n_split,
                              max_edges, stream);
}

int dgll_gat_bwd_softmax(const void* indptr, const void* rows, const void* alpha,
                         const void* dalpha, const void* lgrad, const void* s_row,
                         void* dz, void* dsd, int n_rows, int heads, int across,
                         int group, const void* seg_beg, const void* seg_end,
                         const void* split_row, const void* split_ptr, void* partial,
                         int n_seg, int n_split, int max_edges, void* stream) {
  if (!split_args_ok(n_rows, heads, across, group, n_seg, n_split, max_edges) ||
      (n_seg > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Split sp =
      make_split(seg_beg, seg_end, split_row, split_ptr, n_seg, n_split, max_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gat_bwd_softmax_kernel<<<item_blocks(sp, n_rows, group), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(rows),
      static_cast<const float*>(alpha), static_cast<const float*>(dalpha),
      static_cast<const float*>(lgrad), static_cast<const float*>(s_row),
      static_cast<float*>(dz), static_cast<float*>(dsd), static_cast<float*>(partial), sp,
      n_rows, heads, across, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  combine_segments_kernel<SumOp><<<combine_blocks(sp, heads), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dsd), sp, heads);
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16. vec elements a unit: 16 bytes (4 float32 or 8
// bfloat16; F % vec == 0 and 16-byte aligned pointers) or 1.
int dgll_expand_rows(const void* rows, const void* a, void* out, long long nnz, int f,
                     int dtype, int vec, void* stream) {
  if (nnz < 0 || f <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if ((vec != 1 && vec != wide) || f % vec != 0) return cudaErrorInvalidValue;
  if (vec == wide && !aligned16(a, out)) return cudaErrorMisalignedAddress;
  const int fv = f / vec;
  const int64_t n = (int64_t)nnz * fv;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == wide) return expand_rows<uint4>(rows, a, out, n, fv, s);
  if (dtype == 0) return expand_rows<float>(rows, a, out, n, fv, s);
  return expand_rows<uint16_t>(rows, a, out, n, fv, s);
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
