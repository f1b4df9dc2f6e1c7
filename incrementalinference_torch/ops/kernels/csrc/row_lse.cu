// Streaming row-logsumexp of the pair-product weight matrix, for sm_90a.
//
// Replaces the TPU kernel incrementalinference/jl_tpu/ops/kernels/
// pallas_product.py:_row_lse_kernel (launched by row_logsumexp_pallas).
// For every row i of mixture A it returns
//
//   out_i = log sum_j exp(logW_ij),
//   logW_ij = -0.5 * (a2_i + sum_d iva_id * muB_jd^2 - 2 * sum_d ivmuA_id * muB_jd)
//
// without ever building the (Na, Nb) matrix.  The expanded form is the
// reference's own (a2 + iva.b^2 - 2 ivmuA.b, not (a - b)^2), so the rounding
// stays close to the plain PyTorch version and to the JAX package.
//
// What bounds it on an H100 SXM.  It reads O((Na + Nb) * dof) floats (about
// 1 MB at Na = Nb = 50,000, dof = 1: well under a microsecond at 3.35 TB/s)
// and does, per pair, one exp plus 2 * dof FMAs and about ten other FP32
// instructions (the max/select of the online reduction and expf's range
// reduction).  At 2.5e9 pairs that is bound by operations, not memory:
//   - special-function (MUFU ex2) throughput: 132 SMs x 16 results/clock x
//     1.98 GHz = 4.2e12 exp/s, so 2.5e9 exps take >= 0.6 ms;
//   - FP32 issue: 132 SMs x 128 lanes x 1.98 GHz = 3.3e13 instr/s, so about
//     16 instructions/pair take ~1.2 ms.
// The FP32 issue rate is the binding one; the exp is a sixth of the work.
//
// What the design does about it.
//   - One exp per pair: each lane keeps its own running (max m, sum s) and
//     folds a new value l with e = exp(-|l - m|) into either s*e + 1 (new
//     max) or s + e, instead of the two exps of the max-then-rescale form.
//   - A warp owns ROWS rows of A at once (their a2, iva, ivmuA in
//     registers), so every muB value a lane reads from shared memory feeds
//     ROWS pairs.  Lanes stride over a tile's columns; a warp-shuffle merge
//     of the (m, s) pairs ends each row.
//   - A block stages a tile of muB and muB^2 (TN x dof) in shared memory,
//     laid out [dof][TN] so neighbouring lanes read neighbouring banks.
//   - Occupancy: Na = 50k rows at one thread a row would fill under a fifth
//     of the card's 132 x 2048 thread slots.  Here a row is spread over a
//     warp, and the columns are split across blockIdx.y; a second, tiny
//     kernel combines the per-split (m, s) partials.
//   - IEEE expf/logf (no --use_fast_math); the ragged last tile is masked by
//     the loop bound; the sum is floored at 1e-30 before the log.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kRows = 4;              // rows of A per warp
constexpr int kRowsPerBlock = kWarps * kRows;
constexpr int kTN = 512;              // columns of B per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
row_lse_partial(const float* __restrict__ a2, const float* __restrict__ iva,
                const float* __restrict__ ivmuA,
                const float* __restrict__ muB, float* __restrict__ part_m,
                float* __restrict__ part_s, int na, int nb,
                int cols_per_split) {
  __shared__ float s_b[D * kTN];
  __shared__ float s_b2[D * kTN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRows;

  float c_a2[kRows], c_iva[kRows][D], c_mu[kRows][D];
  float m[kRows], s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(row0 + r, na - 1);   // rows past Na compute junk,
    c_a2[r] = a2[row];                       // never written
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c_iva[r][d] = iva[row * D + d];
      c_mu[r][d] = ivmuA[row * D + d];
    }
    m[r] = -INFINITY;
    s[r] = 0.f;
  }

  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(nb, col_begin + cols_per_split);
  for (int t0 = col_begin; t0 < col_end; t0 += kTN) {
    const int tn = min(kTN, col_end - t0);
    __syncthreads();                         // previous tile fully read
    for (int i = threadIdx.x; i < tn * D; i += blockDim.x) {
      const int c = i / D, d = i - c * D;
      const float b = muB[(size_t)(t0 + c) * D + d];
      s_b[d * kTN + c] = b;
      s_b2[d * kTN + c] = b * b;
    }
    __syncthreads();
    for (int c = lane; c < tn; c += 32) {
      float b[D], b2[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        b[d] = s_b[d * kTN + c];
        b2[d] = s_b2[d * kTN + c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float t2 = 0.f, t3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          t2 = fmaf(c_iva[r][d], b2[d], t2);
          t3 = fmaf(c_mu[r][d], b[d], t3);
        }
        const float l = -0.5f * (c_a2[r] + t2 - 2.f * t3);
        const float diff = l - m[r];
        const float e = expf(-fabsf(diff));
        if (diff > 0.f) {
          s[r] = fmaf(s[r], e, 1.f);
          m[r] = l;
        } else {
          s[r] += e;
        }
      }
    }
  }

  // warp merge of the per-lane (m, s) pairs
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float mr = m[r], sr = s[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mr, off);
      const float so = __shfl_xor_sync(0xffffffffu, sr, off);
      const float mx = fmaxf(mr, mo);
      if (mx == -INFINITY) {
        sr = 0.f;
      } else {
        sr = sr * expf(mr - mx) + so * expf(mo - mx);
      }
      mr = mx;
    }
    const int row = row0 + r;
    if (lane == 0 && row < na) {
      part_m[(size_t)blockIdx.y * na + row] = mr;
      part_s[(size_t)blockIdx.y * na + row] = sr;
    }
  }
}

__global__ void row_lse_combine(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                float* __restrict__ out, int na, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= na) return;
  float mx = -INFINITY;
  for (int k = 0; k < splits; ++k) mx = fmaxf(mx, part_m[(size_t)k * na + row]);
  float sum = 0.f;
  if (mx != -INFINITY) {
    for (int k = 0; k < splits; ++k) {
      const float mk = part_m[(size_t)k * na + row];
      if (mk != -INFINITY) sum += part_s[(size_t)k * na + row] * expf(mk - mx);
    }
  }
  out[row] = mx + logf(fmaxf(sum, 1e-30f));
}

template <int D>
void launch_partial(const float* a2, const float* iva, const float* ivmuA,
                    const float* muB, float* part_m, float* part_s, int na,
                    int nb, int splits, int cols_per_split,
                    cudaStream_t stream) {
  const dim3 grid((na + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  row_lse_partial<D><<<grid, kWarps * 32, 0, stream>>>(
      a2, iva, ivmuA, muB, part_m, part_s, na, nb, cols_per_split);
}

}  // namespace

extern "C" {

// Rows per block and columns per shared-memory tile, for the wrapper's
// choice of the column split.
int row_lse_rows_per_block() { return kRowsPerBlock; }
int row_lse_tile_cols() { return kTN; }

// a2 (na), iva and ivmuA (na, dof), muB (nb, dof), all float32 contiguous;
// part_m and part_s are (splits, na) scratch, out is (na).  Returns
// cudaGetLastError() after the two launches (0 on success).
int row_lse_launch(const float* a2, const float* iva, const float* ivmuA,
                   const float* muB, float* part_m, float* part_s, float* out,
                   int na, int nb, int dof, int splits, int cols_per_split,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (na <= 0 || nb <= 0 || splits <= 0 || cols_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dof) {
#define ROW_LSE_CASE(D)                                                    \
  case D:                                                                  \
    launch_partial<D>(a2, iva, ivmuA, muB, part_m, part_s, na, nb, splits, \
                      cols_per_split, stream);                             \
    break;
    ROW_LSE_CASE(1) ROW_LSE_CASE(2) ROW_LSE_CASE(3) ROW_LSE_CASE(4)
    ROW_LSE_CASE(5) ROW_LSE_CASE(6) ROW_LSE_CASE(7) ROW_LSE_CASE(8)
#undef ROW_LSE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_lse_combine<<<(na + 255) / 256, 256, 0, stream>>>(part_m, part_s, out,
                                                        na, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
