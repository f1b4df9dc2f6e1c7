// Inverse-CDF column draw of the large pair product, for sm_90a.
//
// Replaces no TPU kernel: the JAX package draws the columns of
// pair_product_tangent_large with jax.random.categorical (Gumbel noise and an
// argmax over (rows, Nb) blocks, fused by XLA), and reaches no
// pl.pallas_call there.  For every member b of a batch and every selected
// row r (the A kernel i = ia[b, r], whose terms the caller gathered) this
// kernel draws one column j of B with probability
//
//   w_rj / sum_j w_rj,   w_rj = 2^(l2_rj - shift),
//   l2_rj = c_r + sum_d b_jd (q_rd + p_rd b_jd)      (two FMAs a dimension)
//
// with c = -log2(e)/2 a2, p = -log2(e)/2 iva, q = log2(e) ivmuA: the base-2
// form of row_lse.cu's expanded logW, whose row log-partitions drew the row.
// The caller hands two uniforms a row, u0 and u1, drawn from its key; the
// kernel makes no random number.  ops/kernels/pair_draw.py's
// pair_column_draw_plain is the same algorithm in PyTorch, step by step.
//
// The draw, in a fixed order throughout, with no atomics:
//   1. draw_partial: the columns are cut into splits of kSplitCols (a
//      function of Nb alone); for every (row, split) an online (reference,
//      sum of 2^(l2 - reference)) in registers, B streamed through shared
//      memory as row_lse.cu streams it.  Written to a (members, rows,
//      splits) scratch.
//   2. draw_pick, one warp a row: the splits' sums rescaled to the row's
//      largest reference and folded in split order into the total T; the
//      split is the first whose running sum passes u0 T (the last split of
//      positive sum where rounding leaves the target at or above T).
//   3. The chosen split alone is scanned again, a column a lane, 32
//      consecutive columns a chunk: its largest l2; the weights
//      2^(l2 - that largest l2), each chunk's sum by an xor butterfly over
//      the lanes, the chunks' sums folded in chunk order into the split's
//      total S; the first chunk whose running sum passes u1 S, and in it
//      the first column whose running sum passes it.  Where rounding leaves
//      the target at or above the scan's sums, the chunk's (or the split's)
//      last column of positive weight.
// A column of weight 0 is never returned: a running sum rises past the
// target only by a positive weight.  The split comes from u0 and the column
// inside it from u1, not from the remainder of u0: that remainder would carry
// the partial sums' rounding (summed in another order than the rescan's) into
// the target inside the split, whose columns are each a few thousandths of
// it, so two sound float32 implementations would part on about a row in two
// thousand at the line2-n50k cell's spreads.  Given u1, the choice inside
// the split is the rescan's own arithmetic, which the plain version repeats
// operation for operation: the two agree except where an ex2.approx rounding
// moves a running sum across the target.
//
// What bounds it on an H100 SXM.  The partial pass is row_lse.cu's pass over
// rows x Nb pairs: one exp a pair, least time pairs / (lane rate + SFU rate),
// 0.066 ms for 50,000 x 50,000 (bench_port/lib/peaks.json, the bound of
// draw_roofline_pct); in practice the FP32 issue rate of the pair's six
// slots at dof 1 (2 FMA, max, add, ex2, add).  The pick reads one split of a
// row twice and a chunk once more: 2 / splits of the partial pass's pairs.
//
// What the design does about it.
//   - Rows to warps (kRows a warp, their terms in registers), columns to
//     lanes (kLaneCols of every 32 * kLaneCols-column chunk, read as
//     float4s), muB staged by cp.async into a two-stage ring: row_lse.cu's
//     layout.  The lazy rescale is kde_lse.cu's: l2 is formed first and the
//     reference subtracted after (one add a pair more than row_lse.cu), so
//     a far reference never rounds the pair's exponent.
//   - The pick reads B straight from global memory (L2-resident: Nb x dof
//     floats), 32 consecutive columns a warp-wide load, so every load is
//     coalesced; only the chosen chunk's 32-step scan is serial.
//   - The pair arithmetic is written in explicit round-to-nearest
//     intrinsics, so the compiler contracts nothing differently from the
//     plain version's float32 model.
//   - One launch set a call: the partial pass takes its member from
//     blockIdx.z, the pick from blockIdx.z; a member's bits do not depend on
//     the batch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 4096;      // floats of muB per ring stage
constexpr int kSplitCols = 2048;       // columns a split: a function of Nb
constexpr int kChunks = kSplitCols / 32;    // chunks of 32 columns a split
constexpr float kTau = 32.f;           // log2 headroom of the lazy rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegHalfLog2e = -0.5f * kLog2e;   // exact: a power of two
constexpr unsigned kFull = 0xffffffffu;

// Rows of A per warp, columns per lane and chunk, columns per ring stage:
// row_lse.cu's shape (the row terms take 2 dof + 3 registers a row).
template <int D>
struct Shape {
  static constexpr int kRows = D <= 3 ? 8 : 4;
  static constexpr int kLaneCols = D <= 4 ? 8 : 4;
  static constexpr int kChunk = 32 * kLaneCols;
  static constexpr int kTile = kTileFloats / D / kChunk * kChunk;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// columns [t0, t0 + tn) of muB (Nb, D) into one ring stage, [D][kTile]
template <int D>
__device__ __forceinline__ void stage_tile(float* sb,
                                           const float* __restrict__ muB,
                                           int t0, int tn) {
  const float* src = muB + static_cast<size_t>(t0) * D;
  for (int i = threadIdx.x; i < tn * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    cp_async_f32(sb + d * Shape<D>::kTile + c, src + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// a row's terms c, p, q from a2, iva, ivmuA
template <int D>
__device__ __forceinline__ void row_terms(const float* a2, const float* iva,
                                          const float* ivmuA, int row,
                                          float& c, float (&p)[D],
                                          float (&q)[D]) {
  c = __fmul_rn(kNegHalfLog2e, a2[row]);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p[d] = __fmul_rn(kNegHalfLog2e, iva[static_cast<size_t>(row) * D + d]);
    q[d] = __fmul_rn(kLog2e, ivmuA[static_cast<size_t>(row) * D + d]);
  }
}

// l2 of a row against the column whose D values b points at
template <int D>
__device__ __forceinline__ float log2_weight(float c, const float (&p)[D],
                                             const float (&q)[D],
                                             const float* b) {
  float acc = c;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = b[d];
    acc = __fmaf_rn(__fmaf_rn(p[d], x, q[d]), x, acc);
  }
  return acc;
}

// One chunk: this lane's kLaneCols columns against the warp's kRows rows.
// sb points at the lane's first column; `valid` (Masked only) is how many
// columns of the chunk exist.  cm is minus the lane's reference.
template <int D, bool Masked>
__device__ __forceinline__ void consume_chunk(
    const float* sb, int lane, int valid, const float (&c)[Shape<D>::kRows],
    const float (&p)[Shape<D>::kRows][D], const float (&q)[Shape<D>::kRows][D],
    float (&cm)[Shape<D>::kRows], float (&s)[Shape<D>::kRows]) {
  constexpr int R = Shape<D>::kRows, C = Shape<D>::kLaneCols;
  float b[D][C];
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int g = 0; g < C / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(
          sb + d * Shape<D>::kTile + g * 128);
      b[d][4 * g + 0] = x.x;
      b[d][4 * g + 1] = x.y;
      b[d][4 * g + 2] = x.z;
      b[d][4 * g + 3] = x.w;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float acc = c[r];
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc = __fmaf_rn(__fmaf_rn(p[r][d], b[d][k], q[r][d]), b[d][k], acc);
      if (Masked && (k / 4) * 128 + 4 * lane + (k & 3) >= valid)
        acc = -INFINITY;
      v[k] = acc;
    }
    float mx[C];
#pragma unroll
    for (int k = 0; k < C; ++k) mx[k] = v[k];
#pragma unroll
    for (int h = C / 2; h > 0; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) mx[k] = fmaxf(mx[k], mx[k + h]);
    const float rise = __fadd_rn(mx[0], cm[r]);
    if (__builtin_expect(rise > kTau, 0)) {      // the max rose: move it
      s[r] *= ex2(-rise);
      cm[r] = __fsub_rn(cm[r], rise);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = ex2(__fadd_rn(v[k], cm[r]));
#pragma unroll
    for (int h = C / 2; h > 0; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) v[k] += v[k + h];
    s[r] += v[0];
  }
}

// Grid (row blocks, splits, members).  part_m and part_s are (members, rows,
// splits): the split's reference and its sum of 2^(l2 - reference).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
draw_partial(const float* __restrict__ a2, const float* __restrict__ iva,
             const float* __restrict__ ivmuA, const float* __restrict__ muB,
             float* __restrict__ part_m, float* __restrict__ part_s,
             int rows, int nb) {
  constexpr int R = Shape<D>::kRows, TN = Shape<D>::kTile;
  constexpr int CH = Shape<D>::kChunk;
  __shared__ __align__(16) float s_b[2][D * TN];

  const size_t member = blockIdx.z;
  a2 += member * rows;
  iva += member * rows * D;
  ivmuA += member * rows * D;
  muB += member * nb * D;
  const size_t splits = gridDim.y;
  part_m += member * rows * splits;
  part_s += member * rows * splits;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  const int col_begin = blockIdx.y * kSplitCols;
  const int col_end = min(nb, col_begin + kSplitCols);

  stage_tile<D>(s_b[0], muB, col_begin, min(TN, col_end - col_begin));

  // the reference starts at the row's own l2 at the split's first column
  float c[R], p[R][D], q[R][D], cm[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r, rows - 1);   // rows past the end compute
    row_terms<D>(a2, iva, ivmuA, row, c[r], p[r], q[r]);   // junk, unwritten
    cm[r] = -log2_weight<D>(c[r], p[r], q[r],
                            muB + static_cast<size_t>(col_begin) * D);
    s[r] = 0.f;
  }

  int buf = 0;
  for (int t0 = col_begin; t0 < col_end; t0 += TN, buf ^= 1) {
    const int tn = min(TN, col_end - t0);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();           // tile t0 visible, the other stage fully read
    if (t0 + TN < col_end)
      stage_tile<D>(s_b[buf ^ 1], muB, t0 + TN, min(TN, col_end - t0 - TN));
    const float* sb = s_b[buf] + 4 * lane;
    const int full = tn / CH;
    for (int k = 0; k < full; ++k)
      consume_chunk<D, false>(sb + k * CH, lane, CH, c, p, q, cm, s);
    if (tn - full * CH > 0)
      consume_chunk<D, true>(sb + full * CH, lane, tn - full * CH, c, p, q,
                             cm, s);
  }

  // merge the 32 lanes of each row: max of the references, one rescale, sum
  // (an xor butterfly leaves every lane the same bits)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mref = -cm[r];
    float m = mref;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float t = s[r] * ex2(mref - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(kFull, t, off);
    const int row = row0 + r;
    if (lane == 0 && row < rows) {
      part_m[static_cast<size_t>(row) * splits + blockIdx.y] = m;
      part_s[static_cast<size_t>(row) * splits + blockIdx.y] = t;
    }
  }
}

// Grid (row blocks of kWarps rows, 1, members): one warp a row.  u is
// (members, rows, 2), out (members, rows) column indices.
template <int D>
__global__ void __launch_bounds__(kThreads)
draw_pick(const float* __restrict__ a2, const float* __restrict__ iva,
          const float* __restrict__ ivmuA, const float* __restrict__ muB,
          const float* __restrict__ part_m, const float* __restrict__ part_s,
          const float* __restrict__ u, long long* __restrict__ out, int rows,
          int nb, int splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                       // the whole warp
  const size_t member = blockIdx.z;
  const size_t at = member * rows + row;
  a2 += member * rows;
  iva += member * rows * D;
  ivmuA += member * rows * D;
  muB += member * nb * D;
  const float* pm = part_m + at * splits;
  const float* ps = part_s + at * splits;

  // 1. the split: its sum rescaled to the row's largest reference, folded
  //    in split order (every lane the same arithmetic)
  float big = pm[0];
  for (int k = 1; k < splits; ++k) big = fmaxf(big, pm[k]);
  float total = 0.f;
  for (int k = 0; k < splits; ++k)
    total = __fadd_rn(total,
                      __fmul_rn(ps[k], exp2f(__fsub_rn(pm[k], big))));
  const float target = __fmul_rn(u[2 * at], total);
  int split = -1, last = 0;
  float run = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float w = __fmul_rn(ps[k], exp2f(__fsub_rn(pm[k], big)));
    run = __fadd_rn(run, w);
    if (w > 0.f) last = k;
    if (run > target) {
      split = k;
      break;
    }
  }
  if (split < 0) split = last;

  // 2. that split's largest l2; lane l reads columns l, l + 32, ...
  const int c0 = split * kSplitCols;
  const int len = min(kSplitCols, nb - c0);
  const float* b = muB + static_cast<size_t>(c0) * D;
  float c, p[D], q[D];
  row_terms<D>(a2, iva, ivmuA, row, c, p, q);
  float top = -INFINITY;
  for (int j = lane; j < len; j += 32)
    top = fmaxf(top, log2_weight<D>(c, p, q, b + static_cast<size_t>(j) * D));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(kFull, top, off));

  // 3. the weights 2^(l2 - top) by chunks of 32 columns, a column a lane:
  //    each chunk's sum by an xor butterfly (every lane the same bits), the
  //    chunks folded in order into the split's total; lane k % 32 keeps
  //    chunk k's sum in mine[k / 32]
  float mine[kChunks / 32];
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = k * 32 + lane;
    float w = j < len ? ex2(__fsub_rn(log2_weight<D>(
                            c, p, q, b + static_cast<size_t>(j) * D), top))
                      : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = __fadd_rn(w, __shfl_xor_sync(kFull, w, off));
    if (lane == (k & 31)) mine[k >> 5] = w;
    tot = __fadd_rn(tot, w);
  }
  const float goal = __fmul_rn(u[2 * at + 1], tot);

  // 4. the first chunk whose running sum passes the goal, by the same fold;
  //    else the last chunk of positive sum (there is one for finite
  //    inputs: the column of the largest l2 weighs 1)
  int chunk = -1, last_chunk = 0;
  float acc = 0.f, before = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const float x = __shfl_sync(kFull, mine[k >> 5], k & 31);
    const float prev = acc;
    acc = __fadd_rn(acc, x);
    if (x > 0.f) last_chunk = k;
    if (chunk < 0 && acc > goal) {
      chunk = k;
      before = prev;
    }
  }
  const bool fallback = chunk < 0;
  if (fallback) chunk = last_chunk;

  // 5. in that chunk, from the running sum before it: the first column past
  //    the goal, else its last of positive weight
  const int j = chunk * 32 + lane;
  const float w = j < len ? ex2(__fsub_rn(log2_weight<D>(
                                c, p, q, b + static_cast<size_t>(j) * D),
                            top))
                          : 0.f;
  int col = -1, last_col = 0;
  acc = before;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = __shfl_sync(kFull, w, i);
    acc = __fadd_rn(acc, x);
    if (x > 0.f) last_col = i;
    if (!fallback && col < 0 && acc > goal) col = i;
  }
  if (lane == 0) out[at] = c0 + chunk * 32 + (col >= 0 ? col : last_col);
}

}  // namespace

#define PAIR_DRAW_FOR_EACH_DOF(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" {

// Columns a split covers: the split count is ceil(nb / this), for any rows.
int pair_draw_split_cols() { return kSplitCols; }

// Chunks of 32 columns a split holds in the pick.
int pair_draw_chunks() { return kChunks; }

// A batch of `members` independent draws, member after member: a2 (members,
// rows), iva and ivmuA (members, rows, dof) the selected rows' terms, muB
// (members, nb, dof), u (members, rows, 2) uniforms in [0), all float32
// contiguous; part_m and part_s are (members, rows, ceil(nb /
// pair_draw_split_cols())) scratch, out is (members, rows) int64.  Returns
// cudaGetLastError() after the two launches (0 on success).
int pair_draw_launch(const float* a2, const float* iva, const float* ivmuA,
                     const float* muB, const float* u, float* part_m,
                     float* part_s, long long* out, int rows, int nb, int dof,
                     int members, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows <= 0 || nb <= 0 || members <= 0 || members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (nb + kSplitCols - 1) / kSplitCols;
  const dim3 pick_grid((rows + kWarps - 1) / kWarps, 1, members);
  switch (dof) {
#define X(D)                                                                 \
  case D: {                                                                  \
    constexpr int rpb = kWarps * Shape<D>::kRows;                            \
    const dim3 grid((rows + rpb - 1) / rpb, splits, members);                \
    draw_partial<D><<<grid, kThreads, 0, stream>>>(a2, iva, ivmuA, muB,      \
                                                   part_m, part_s, rows, nb); \
    cudaError_t err = cudaGetLastError();                                    \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    draw_pick<D><<<pick_grid, kThreads, 0, stream>>>(                        \
        a2, iva, ivmuA, muB, part_m, part_s, u, out, rows, nb, splits);      \
    break;                                                                   \
  }
    PAIR_DRAW_FOR_EACH_DOF(X)
#undef X
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
