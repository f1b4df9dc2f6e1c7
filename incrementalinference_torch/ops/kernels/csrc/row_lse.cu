// Streaming row-logsumexp of the pair-product weight matrix, for sm_90a.
//
// Replaces the TPU kernel incrementalinference/jl_tpu/ops/kernels/
// pallas_product.py:_row_lse_kernel (launched by row_logsumexp_pallas).
// For every row i of mixture A it returns
//
//   out_i = log sum_j exp(logW_ij),
//   logW_ij = -0.5 * (a2_i + sum_d iva_id * muB_jd^2 - 2 * sum_d ivmuA_id * muB_jd)
//
// without ever building the (Na, Nb) matrix; the sum is floored at 1e-30
// before the log.  tests/test_torch_kernels.py:emulate_row_lse is this
// kernel's model: the same recurrence, step by step, in PyTorch on the CPU.
//
// What bounds it on an H100 SXM.  It reads O((Na + Nb) * dof) floats (about
// 1 MB at Na = Nb = 50,000, dof = 1) and does one exp per pair, so it is
// bound by operations.  An SM sub-partition starts one warp instruction a
// clock and its special-function unit (MUFU) finishes one warp-wide ex2 in
// 8 clocks.  So the exp unit is the limit (132 SMs x 16 exp/clock) only
// while everything else a pair needs stays under 8 such slots; above that,
// the FP32 instruction rate is.  The design spends, at dof = 1, 5 slots a
// pair (2 FMA, 1 max, 1 ex2, 1 add) and a compare and a branch per 8 pairs.
//
// What the design does about it.
//   - Base 2, constants folded into the row terms: c = -0.5 log2e a2,
//     p_d = -0.5 log2e iva_d, q_d = log2e ivmuA_d, and the log2-weight is
//     l2 = c + sum_d b_d (q_d + p_d b_d): two FMAs per dof in Horner form,
//     nothing after them, and no tile of squares.  The result leaves as
//     (m + log2 s) ln 2.
//   - One bare ex2.approx.ftz.f32 per pair (2^-22 relative error, 0 for
//     very negative input, no range reduction).  The file is compiled
//     without --use_fast_math: exp2f/log2f in the combine kernel are IEEE.
//   - The max is taken per chunk, not per pair, and the rescale is lazy.
//     A lane keeps for each of its rows a reference m_ref and
//     s = sum 2^(l2 - m_ref); -m_ref is folded into the FMA's addend
//     (cm = c - m_ref), so a pair costs no subtract.  A chunk of kLaneCols
//     values goes straight into s while its max stays under m_ref + kTau;
//     only when it does not is m_ref moved (s *= 2^-rise).  m_ref starts
//     from the row's log2-weight at the first column of the block's column
//     range, a real value, never from -inf: l2 <= 0 up to rounding, so
//     overflow is never the risk (2^32 x 65,536 terms is far from the fp32
//     range); underflow of rows far from every B kernel is, and m_ref
//     absorbs it.  A lane whose own values all lie far below that shared
//     start adds 0, which is their true share of a sum that is >= 1.
//   - A warp owns kRows rows of A (their p, q in registers); a lane owns
//     kLaneCols columns of every 32 * kLaneCols-column chunk, read from
//     shared memory as float4s, so one LDS feeds 4 * kRows pairs.
//   - muB is staged by cp.async into a two-stage ring, laid out [dof][tile]
//     so the float4 reads have no bank conflicts: the next tile arrives
//     while this one is consumed, one __syncthreads a tile.
//   - The grid is (row blocks, column splits, members of a batch); the
//     wrapper picks the split count that fills the last wave of resident
//     blocks (row_lse_resident_blocks), counting every member's blocks, so a
//     batch of same-level cliques (the JAX package vmaps the Pallas call
//     over them) is one launch and fills waves a single problem cannot.  Lanes merge by shuffles (max, one rescale,
//     sum), splits by a second, tiny kernel: no atomics, so the result is
//     the same from run to run.
//   - Tensor cores stay out: the contraction depth is 1 + 2 dof <= 17, fp32
//     accuracy would need a 3 x TF32 split of every operand, and at dof = 1
//     the FMAs are 2 of the 5 slots.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 4096;     // floats of muB per ring stage
constexpr float kTau = 32.f;          // log2 headroom of the lazy rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Rows of A per warp, columns per lane and chunk, columns per ring stage.
// The row terms take (2 dof + 3) registers a row: 8 rows fit under the 128
// registers of two resident blocks up to dof 3, 4 rows above; from dof 5 a
// lane holds 4 columns of B a chunk instead of 8.
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

// log2-weight of row (p, q, cm) against column k of the lane's chunk, less
// m_ref; -inf for a column past the end (Masked only)
template <int D, bool Masked, int C>
__device__ __forceinline__ float log2_weight(const float (&p)[D],
                                             const float (&q)[D], float cm,
                                             const float (&b)[D][C], int k,
                                             int lane, int valid) {
  float acc = cm;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(fmaf(p[d], b[d][k], q[d]), b[d][k], acc);
  if (Masked && (k / 4) * 128 + 4 * lane + (k & 3) >= valid) acc = -INFINITY;
  return acc;
}

// One chunk: this lane's kLaneCols columns against the warp's kRows rows.
// sb points at the lane's first column; `valid` (Masked only) is how many
// columns of the chunk exist.
template <int D, bool Masked>
__device__ __forceinline__ void consume_chunk(
    const float* sb, int lane, int valid,
    const float (&p)[Shape<D>::kRows][D], const float (&q)[Shape<D>::kRows][D],
    float (&cm)[Shape<D>::kRows], float (&mref)[Shape<D>::kRows],
    float (&s)[Shape<D>::kRows]) {
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
    for (int k = 0; k < C; ++k)
      v[k] = log2_weight<D, Masked>(p[r], q[r], cm[r], b, k, lane, valid);
    float mx[C];
#pragma unroll
    for (int k = 0; k < C; ++k) mx[k] = v[k];
#pragma unroll
    for (int w = C / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) mx[k] = fmaxf(mx[k], mx[k + w]);
    if (__builtin_expect(mx[0] > kTau, 0)) {     // the max rose: move m_ref
      s[r] *= ex2(-mx[0]);
      mref[r] += mx[0];
      cm[r] -= mx[0];
#pragma unroll
      for (int k = 0; k < C; ++k) v[k] -= mx[0];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = ex2(v[k]);
#pragma unroll
    for (int w = C / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) v[k] += v[k + w];
    s[r] += v[0];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
row_lse_partial(const float* __restrict__ a2, const float* __restrict__ iva,
                const float* __restrict__ ivmuA,
                const float* __restrict__ muB, float* __restrict__ part_m,
                float* __restrict__ part_s, int na, int nb,
                int cols_per_split) {
  constexpr int R = Shape<D>::kRows, TN = Shape<D>::kTile;
  constexpr int CH = Shape<D>::kChunk;
  __shared__ __align__(16) float s_b[2][D * TN];

  // the member of the batch: its own A rows, B columns and partials
  const size_t member = blockIdx.z;
  a2 += member * na;
  iva += member * na * D;
  ivmuA += member * na * D;
  muB += member * nb * D;
  part_m += member * gridDim.y * na;
  part_s += member * gridDim.y * na;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(nb, col_begin + cols_per_split);

  stage_tile<D>(s_b[0], muB, col_begin, min(TN, col_end - col_begin));

  float p[R][D], q[R][D], cm[R], mref[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r, na - 1);   // rows past Na compute junk,
    const float c = -0.5f * kLog2e * a2[row];  // never written
    float l = c;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[r][d] = -0.5f * kLog2e * iva[row * D + d];
      q[r][d] = kLog2e * ivmuA[row * D + d];
      const float b0 = muB[static_cast<size_t>(col_begin) * D + d];
      l = fmaf(fmaf(p[r][d], b0, q[r][d]), b0, l);
    }
    mref[r] = l;
    cm[r] = c - l;
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
      consume_chunk<D, false>(sb + k * CH, lane, CH, p, q, cm, mref, s);
    if (tn - full * CH > 0)
      consume_chunk<D, true>(sb + full * CH, lane, tn - full * CH, p, q, cm,
                             mref, s);
  }

  // merge the 32 lanes of each row: max of m_ref, one rescale, sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = mref[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float t = s[r] * ex2(mref[r] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    const int row = row0 + r;
    if (lane == 0 && row < na) {
      part_m[static_cast<size_t>(blockIdx.y) * na + row] = m;
      part_s[static_cast<size_t>(blockIdx.y) * na + row] = t;
    }
  }
}

// merge the column splits' (m, s) pairs (base 2) and leave base e; one
// thread per row of the whole batch, partials laid out (batch, splits, na)
__global__ void row_lse_combine(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                float* __restrict__ out, int na, int splits,
                                int batch) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= static_cast<size_t>(batch) * na) return;
  const size_t member = r / na, row = r - member * na;
  const float* pm = part_m + member * splits * na + row;
  const float* ps = part_s + member * splits * na + row;
  float mx = pm[0];
  for (int k = 1; k < splits; ++k)
    mx = fmaxf(mx, pm[static_cast<size_t>(k) * na]);
  float sum = 0.f;
  for (int k = 0; k < splits; ++k)
    sum += ps[static_cast<size_t>(k) * na] *
           exp2f(pm[static_cast<size_t>(k) * na] - mx);
  out[r] = (mx + log2f(fmaxf(sum, 1e-30f))) * kLn2;
}

template <int D>
int resident_blocks() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_lse_partial<D>, kThreads, 0) != cudaSuccess)
    return -1;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

}  // namespace

#define ROW_LSE_FOR_EACH_DOF(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" {

// Rows of A per block at this dof, for the wrapper's choice of the split.
int row_lse_rows_per_block(int dof) {
  switch (dof) {
#define X(D) \
  case D:    \
    return kWarps * Shape<D>::kRows;
    ROW_LSE_FOR_EACH_DOF(X)
#undef X
  }
  return -1;
}

// Columns a warp consumes per chunk at this dof: a column split that is a
// multiple of it has no masked chunk but the matrix's last.
int row_lse_chunk_cols(int dof) {
  switch (dof) {
#define X(D) \
  case D:    \
    return Shape<D>::kChunk;
    ROW_LSE_FOR_EACH_DOF(X)
#undef X
  }
  return -1;
}

// Blocks of the dof's kernel that the current device holds at once.
int row_lse_resident_blocks(int dof) {
  switch (dof) {
#define X(D) \
  case D:    \
    return resident_blocks<D>();
    ROW_LSE_FOR_EACH_DOF(X)
#undef X
  }
  return -1;
}

// A batch of `batch` independent problems, member after member:
// a2 (batch, na), iva and ivmuA (batch, na, dof), muB (batch, nb, dof), all
// float32 contiguous; part_m and part_s are (batch, splits, na) scratch,
// out is (batch, na).  The splits cover nb columns, cols_per_split each,
// none empty.  The partial kernel takes its member from blockIdx.z, so a
// whole batch is one launch of each kernel.  Returns cudaGetLastError()
// after the two launches (0 on success).
int row_lse_launch(const float* a2, const float* iva, const float* ivmuA,
                   const float* muB, float* part_m, float* part_s, float* out,
                   int na, int nb, int dof, int splits, int cols_per_split,
                   int batch, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = row_lse_rows_per_block(dof);
  if (rows <= 0 || na <= 0 || nb <= 0 || splits <= 0 || cols_per_split <= 0 ||
      batch <= 0 || batch > 65535 ||
      static_cast<long long>(splits - 1) * cols_per_split >= nb ||
      static_cast<long long>(splits) * cols_per_split < nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((na + rows - 1) / rows, splits, batch);
  switch (dof) {
#define X(D)                                                      \
  case D:                                                         \
    row_lse_partial<D><<<grid, kThreads, 0, stream>>>(            \
        a2, iva, ivmuA, muB, part_m, part_s, na, nb, cols_per_split); \
    break;
    ROW_LSE_FOR_EACH_DOF(X)
#undef X
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * na;
  row_lse_combine<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(part_m, part_s, out, na, splits, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
