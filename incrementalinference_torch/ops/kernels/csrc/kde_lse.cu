// Streaming row-logsumexp of Gaussian-kernel weights on a manifold (the
// KDE read of beliefs.kde_logpdf), for sm_90a.
//
// Replaces no TPU kernel: the JAX package's kde_logpdf
// (incrementalinference/jl_tpu/beliefs.py) reaches no pl.pallas_call; XLA
// fuses its pairwise log map there.  The port's eager form of the same read
// makes some 40 elementwise passes over (rows, N, dof) chunks, so this
// kernel was added.  For every member b of a batch and every query row i it
// returns
//
//   out_bi = log sum_j exp(-1/2 sum_d (log_{p_bj}(q_bi)_d / bw_bd)^2)
//
// over the kernel particles p_bj, j < N, without building any (Q, N, dof)
// tensor; the caller subtracts log N and the bandwidth normaliser.
// Manifolds: Euclidean(D), D = 1..8 (log_p(q) = q - p); SE(2), points
// (x, y, theta), where log_p(q) = Log(p^-1 q) as manifolds/lie.py SE2.log
// computes it:
//
//   t   = R(w) (q_xy - p_xy),  w = wrap(-theta_p)   (the difference form of
//                                                    inverse and compose)
//   phi = wrap(theta_q - theta_p)
//   A   = sin(phi) / phi,  B = (1 - cos(phi)) / phi  (1 - phi^2/6 and phi/2
//                                                    where |phi| <= 1e-8)
//   rho = [[A, B], [-B, A]] t / max(A^2 + B^2, 1e-8),  tangent (rho, phi)
//
// with wrap(t) = t - 2pi rint(t / 2pi) as manifolds/base.py wrap_angle.
// A and C = B / phi are polynomials of degree 6 in u = phi^2, fitted on
// [0, (1.001 pi)^2] to 8.2e-10 and 5.2e-11; their float32 coefficients lie
// 9.0e-8 and 1.8e-8 from the functions there, 1.5e-7 and 4.5e-8 in float32
// Horner form, about an ulp of 1 (tests/test_torch_kde_kernel.py holds them).
// No sine is rebuilt from products of per-point sines and cosines, which
// would lose the digits of A at small phi; cos(w) and sin(w) are IEEE
// sincosf, once a particle.
//
// SE(3), points (t[3], quaternion w, x, y, z), where log_p(q) =
// Log(p^-1 q) as manifolds/lie.py SE3.log computes it, its small-angle
// branches and its clamps included:
//
//   a   = conj(quat_p)                   (the inverse's rotation, a term)
//   r   = a quat_q, negated where r_w < 0 (the relative rotation, r_w >= 0)
//   d   = a (t_q - t_p) a*               (the difference form of inverse
//                                         and compose)
//   u   = sqrt(|r_xyz|^2 + 1e-24),  theta = 2 atan2(u, r_w)
//   phi = r_xyz theta / u                (r_xyz 2 / max(r_w, 1e-8) where
//                                         u <= 1e-8)
//   s   = sqrt(|phi|^2 + 1e-24)
//   c   = (1 - s sin(s) / (2 max(1 - cos(s), 1e-8))) / s^2  (1/12 + s^2/720
//                                                            where s <= 1e-8)
//   rho = d - phi x d / 2 + c phi x (phi x d),  tangent (rho, phi)
//
// For the unit r, sin(theta) = 2 r_w u and 1 - cos(theta) = 2 u^2, so c is
// taken as (m - s r_w u) / (m s^2), m = max(2 u^2, 1e-8): no cosine of a
// small angle, whose 1 - cos(s) float32 loses whole below s ~ 3e-4 (and with
// it the eager float32 route's V^-1 there).  r is not renormalised: theta,
// phi and c's unclamped form do not depend on its norm, and the points are
// unit to float32.  The reciprocals are rcp.approx (1 ulp).
//
// What bounds it on an H100 SXM.  It reads O((N + Q) * point_dim) floats and
// does one exponential a pair: the least time is pairs / (lane rate + SFU
// rate), 0.066 ms for 50,000 x 50,000 (bench_port/lib/peaks.json, the bound
// of kde_roofline_pct).  The log map costs more than that exponential: a
// Euclidean pair takes 3 FP32 operations a dimension, an SE(2) pair about 50
// (the two polynomials, the rotation, the wrap, one reciprocal on the SFU),
// so the FP32 issue rate is the practical limit, about 3.7 ms an SE(2)
// 50k x 50k read.  An SE(3) pair takes about 130 (the quaternion product and
// rotation, two square roots, an arctangent, three reciprocals, V^-1), so
// FP32 issue bounds it harder still (bench_port's kde_se3_roofline_pct).
//
// What the design does about it.
//   - The per-particle terms (for SE(2) the translation, theta and the
//     cosine and sine of wrap(-theta) that the inverse needs; for SE(3) the
//     translation and the inverse's quaternion) are worked out
//     once a particle by kde_lse_prep into a [term][N] array, then streamed
//     through shared memory by cp.async into a two-stage ring, as row_lse.cu
//     streams muB.  A warp holds kRows query rows in registers, a lane reads
//     kLaneCols columns of every 32 * kLaneCols-column chunk as float4s.
//   - Each pair's log map, scaled square and the online base-2 logsumexp stay
//     in registers.  The bandwidths fold into w_d = sqrt(log2(e) / 2) / bw_d,
//     so a pair's log2-weight is l2 = -sum_d (X_d w_d)^2; the lazy rescale is
//     row_lse.cu's (a reference m_ref per row and lane, moved only when a
//     chunk's max rises past it by kTau; one ex2.approx a pair), except that
//     l2 is formed first and m_ref subtracted after, one add a pair more:
//     m_ref starts at the row's weight at the split's first column, often
//     hundreds below the row's maximum, and folded into the sum it rounded
//     the chunk that moves it at that magnitude (2e-5 in log-density).
//   - The difference form throughout: (q - p) w, never |q|^2 + |p|^2 - 2 q.p,
//     which loses |q|^2 * 1e-7 far from the origin.
//   - Deterministic, and a row's value does not depend on the rest of the
//     query: the column split is a function of N alone (kSplitCols columns a
//     split), a lane's columns and their order depend on the column only, the
//     lanes merge by a fixed shuffle tree and the splits by a second kernel
//     in split order.  The pair arithmetic is written in explicit
//     round-to-nearest intrinsics, so the compiler contracts no product into
//     an FMA differently for one row slot than for another.  No atomics.
//   - Full float32: no bf16, no TF32, no pair skipped, no far kernel
//     truncated.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 4096;     // floats of particle terms a ring stage
constexpr int kSplitCols = 2048;      // columns a split: a function of N only
constexpr float kTau = 32.f;          // log2 headroom of the lazy rescale
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSqrtHalfLog2e = 0.8493218002880191f;  // sqrt(log2(e) / 2)
constexpr float kEps = 1e-8f;         // manifolds/lie.py _EPS
constexpr float kTwoPi = 6.2831853071795865f;
constexpr float kInvTwoPi = 1.f / 6.2831853071795865f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wrap_angle: t - 2pi rint(t / 2pi), as PyTorch evaluates it on the card
// (the division by a scalar as a product by its reciprocal)
__device__ __forceinline__ float wrap(float t) {
  return __fsub_rn(t, __fmul_rn(kTwoPi, rintf(__fmul_rn(t, kInvTwoPi))));
}

template <int K>
__device__ __forceinline__ float horner(const float (&c)[K], float u) {
  float acc = c[K - 1];
#pragma unroll
  for (int k = K - 2; k >= 0; --k) acc = fmaf(acc, u, c[k]);
  return acc;
}

// sin(phi)/phi as a polynomial in u = phi^2
__device__ __forceinline__ float sinc_of_square(float u) {
  constexpr float kSinc[7] = {1.000000000e+00f, -1.666666567e-01f,
                              8.333323523e-03f, -1.984059782e-04f,
                              2.753692343e-06f, -2.473739436e-08f,
                              1.363940627e-10f};
  return horner(kSinc, u);
}

// (1 - cos(phi))/phi^2 as a polynomial in u = phi^2
__device__ __forceinline__ float vers_of_square(float u) {
  constexpr float kVers[7] = {5.000000000e-01f, -4.166666791e-02f,
                              1.388888224e-03f, -2.480116200e-05f,
                              2.754440231e-07f, -2.067777505e-09f,
                              9.945553062e-12f};
  return horner(kVers, u);
}

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Euclidean(D): a particle's terms are its coordinates, a row's the query's.
template <int D>
struct Euclid {
  static constexpr int kPointDim = D;
  static constexpr int kDof = D;
  static constexpr int kTerms = D;        // floats a particle streams
  static constexpr int kRowTerms = D;     // floats a query row holds
  static constexpr int kRows = D <= 3 ? 8 : 4;
  static constexpr int kLaneCols = D <= 4 ? 8 : 4;

  __device__ static void prep(const float* p, float* t) {
#pragma unroll
    for (int d = 0; d < D; ++d) t[d] = p[d];
  }
  __device__ static void row(const float* q, float* r) {
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = q[d];
  }
  // acc - sum_d ((q_d - p_d) w_d)^2
  __device__ static float pair(const float (&r)[D], const float (&t)[D],
                               const float (&w)[D], float acc) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float z = __fmul_rn(__fsub_rn(r[d], t[d]), w[d]);
      acc = fmaf(-z, z, acc);
    }
    return acc;
  }
};

// SE(2): terms (x, y, theta, cos w, sin w) of a particle, w = wrap(-theta);
// a row's (x, y, theta).
struct SE2 {
  static constexpr int kPointDim = 3;
  static constexpr int kDof = 3;
  static constexpr int kTerms = 5;
  static constexpr int kRowTerms = 3;
  static constexpr int kRows = 8;
  static constexpr int kLaneCols = 4;

  __device__ static void prep(const float* p, float* t) {
    float s, c;
    sincosf(wrap(-p[2]), &s, &c);
    t[0] = p[0];
    t[1] = p[1];
    t[2] = p[2];
    t[3] = c;
    t[4] = s;
  }
  __device__ static void row(const float* q, float* r) {
    r[0] = q[0];
    r[1] = q[1];
    r[2] = q[2];
  }
  __device__ static float pair(const float (&r)[3], const float (&t)[5],
                               const float (&w)[3], float acc) {
    const float dx = __fsub_rn(r[0], t[0]), dy = __fsub_rn(r[1], t[1]);
    const float c = t[3], s = t[4];
    const float tx = fmaf(c, dx, -__fmul_rn(s, dy));      // R(w) (q - p)
    const float ty = fmaf(s, dx, __fmul_rn(c, dy));
    const float phi = wrap(__fsub_rn(r[2], t[2]));
    const float u = __fmul_rn(phi, phi);
    float A = sinc_of_square(u);
    float B = __fmul_rn(phi, vers_of_square(u));
    if (!(fabsf(phi) > kEps)) {                            // the Taylor forms
      A = __fsub_rn(1.f, __fmul_rn(u, 1.f / 6.f));
      B = __fmul_rn(0.5f, phi);
    }
    const float inv = rcp(fmaxf(fmaf(B, B, __fmul_rn(A, A)), kEps));
    const float rx = fmaf(A, tx, __fmul_rn(B, ty));
    const float ry = fmaf(A, ty, -__fmul_rn(B, tx));
    const float zx = __fmul_rn(__fmul_rn(rx, inv), w[0]);
    const float zy = __fmul_rn(__fmul_rn(ry, inv), w[1]);
    const float zt = __fmul_rn(phi, w[2]);
    acc = fmaf(-zx, zx, acc);
    acc = fmaf(-zy, zy, acc);
    return fmaf(-zt, zt, acc);
  }
};

// SE(3): terms (t_x, t_y, t_z, w, -x, -y, -z) of a particle, its translation
// and the rotation of its inverse; a row's (t, quaternion) as stored.  Four
// rows a warp: eight would hold 56 row terms and spill past the 128
// registers that two blocks an SM leave a thread.
struct SE3 {
  static constexpr int kPointDim = 7;
  static constexpr int kDof = 6;
  static constexpr int kTerms = 7;
  static constexpr int kRowTerms = 7;
  static constexpr int kRows = 4;
  static constexpr int kLaneCols = 4;

  __device__ static void prep(const float* p, float* t) {
    t[0] = p[0];
    t[1] = p[1];
    t[2] = p[2];
    t[3] = p[3];
    t[4] = -p[4];
    t[5] = -p[5];
    t[6] = -p[6];
  }
  __device__ static void row(const float* q, float* r) {
#pragma unroll
    for (int k = 0; k < 7; ++k) r[k] = q[k];
  }
  // a x b, written out
  __device__ static void cross(float ax, float ay, float az, float bx,
                               float by, float bz, float& cx, float& cy,
                               float& cz) {
    cx = fmaf(ay, bz, -__fmul_rn(az, by));
    cy = fmaf(az, bx, -__fmul_rn(ax, bz));
    cz = fmaf(ax, by, -__fmul_rn(ay, bx));
  }
  __device__ static float pair(const float (&r)[7], const float (&t)[7],
                               const float (&w)[6], float acc) {
    const float dx = __fsub_rn(r[0], t[0]), dy = __fsub_rn(r[1], t[1]),
                dz = __fsub_rn(r[2], t[2]);
    const float aw = t[3], ax = t[4], ay = t[5], az = t[6];
    const float bw = r[3], bx = r[4], by = r[5], bz = r[6];
    // r = a b, then the sign that makes r_w >= 0
    float qw = fmaf(aw, bw, -fmaf(ax, bx, fmaf(ay, by, __fmul_rn(az, bz))));
    float qx = fmaf(aw, bx, fmaf(ax, bw, fmaf(ay, bz, -__fmul_rn(az, by))));
    float qy = fmaf(aw, by, fmaf(-ax, bz, fmaf(ay, bw, __fmul_rn(az, bx))));
    float qz = fmaf(aw, bz, fmaf(ax, by, fmaf(-ay, bx, __fmul_rn(az, bw))));
    const float sg = qw < 0.f ? -1.f : 1.f;
    qw = __fmul_rn(sg, qw);
    qx = __fmul_rn(sg, qx);
    qy = __fmul_rn(sg, qy);
    qz = __fmul_rn(sg, qz);
    // d rotated by a: d + 2 (a_w (v x d) + v x (v x d)), v = a_xyz
    float c1x, c1y, c1z, c2x, c2y, c2z;
    cross(ax, ay, az, dx, dy, dz, c1x, c1y, c1z);
    cross(ax, ay, az, c1x, c1y, c1z, c2x, c2y, c2z);
    const float tx = fmaf(2.f, fmaf(aw, c1x, c2x), dx);
    const float ty = fmaf(2.f, fmaf(aw, c1y, c2y), dy);
    const float tz = fmaf(2.f, fmaf(aw, c1z, c2z), dz);
    // the rotation vector
    const float u2 = fmaf(qx, qx, fmaf(qy, qy, fmaf(qz, qz, 1e-24f)));
    const float u = __fsqrt_rn(u2);
    const float theta = __fmul_rn(2.f, atan2f(u, qw));
    const float scale = u > kEps ? __fmul_rn(theta, rcp(u))
                                 : __fmul_rn(2.f, rcp(fmaxf(qw, kEps)));
    const float px = __fmul_rn(scale, qx), py = __fmul_rn(scale, qy),
                pz = __fmul_rn(scale, qz);
    const float s2 = fmaf(px, px, fmaf(py, py, fmaf(pz, pz, 1e-24f)));
    const float s = __fsqrt_rn(s2);
    // V^-1's coefficient of K^2
    const float m = fmaxf(__fmul_rn(2.f, u2), kEps);
    float c = __fmul_rn(fmaf(-__fmul_rn(s, qw), u, m), rcp(__fmul_rn(m, s2)));
    if (!(s > kEps)) c = fmaf(s2, 1.f / 720.f, 1.f / 12.f);
    // rho = d - phi x d / 2 + c phi x (phi x d)
    float e1x, e1y, e1z, e2x, e2y, e2z;
    cross(px, py, pz, tx, ty, tz, e1x, e1y, e1z);
    cross(px, py, pz, e1x, e1y, e1z, e2x, e2y, e2z);
    const float rx = fmaf(c, e2x, fmaf(-0.5f, e1x, tx));
    const float ry = fmaf(c, e2y, fmaf(-0.5f, e1y, ty));
    const float rz = fmaf(c, e2z, fmaf(-0.5f, e1z, tz));
    const float z[6] = {__fmul_rn(rx, w[0]), __fmul_rn(ry, w[1]),
                        __fmul_rn(rz, w[2]), __fmul_rn(px, w[3]),
                        __fmul_rn(py, w[4]), __fmul_rn(pz, w[5])};
#pragma unroll
    for (int k = 0; k < 6; ++k) acc = fmaf(-z[k], z[k], acc);
    return acc;
  }
};

template <class M>
struct Shape {
  static constexpr int kChunk = 32 * M::kLaneCols;
  static constexpr int kTile = kTileFloats / M::kTerms / kChunk * kChunk;
};

// The per-particle terms: points (members, n, point_dim) to terms
// (members, kTerms, n).
template <class M>
__global__ void kde_lse_prep(const float* __restrict__ points,
                             float* __restrict__ terms, int n, int members) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(members) * n) return;
  const size_t member = i / n, j = i - member * n;
  float t[M::kTerms];
  M::prep(points + i * M::kPointDim, t);
  float* out = terms + member * M::kTerms * n + j;
#pragma unroll
  for (int k = 0; k < M::kTerms; ++k) out[static_cast<size_t>(k) * n] = t[k];
}

// columns [t0, t0 + tn) of terms (kTerms, n) into one ring stage,
// [kTerms][kTile]
template <class M>
__device__ __forceinline__ void stage_tile(float* sb,
                                           const float* __restrict__ terms,
                                           int n, int t0, int tn) {
#pragma unroll
  for (int k = 0; k < M::kTerms; ++k)
    for (int c = threadIdx.x; c < tn; c += kThreads)
      cp_async_f32(sb + k * Shape<M>::kTile + c,
                   terms + static_cast<size_t>(k) * n + t0 + c);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One chunk: this lane's kLaneCols columns against the warp's kRows rows.
// sb points at the lane's first column; `valid` (Masked only) is how many
// columns of the chunk exist.
template <class M, bool Masked>
__device__ __forceinline__ void consume_chunk(
    const float* sb, int lane, int valid,
    const float (&r)[M::kRows][M::kRowTerms], const float (&w)[M::kDof],
    float (&cm)[M::kRows], float (&mref)[M::kRows], float (&s)[M::kRows]) {
  constexpr int R = M::kRows, C = M::kLaneCols, T = M::kTerms;
  float b[C][T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
#pragma unroll
    for (int g = 0; g < C / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(
          sb + k * Shape<M>::kTile + g * 128);
      b[4 * g + 0][k] = x.x;
      b[4 * g + 1][k] = x.y;
      b[4 * g + 2][k] = x.z;
      b[4 * g + 3][k] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // the log2-weights themselves, so that a rescale re-references them
    // without the rounding of a far m_ref folded in
    float v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = M::pair(r[i], b[k], w, 0.f);
      if (Masked && (k / 4) * 128 + 4 * lane + (k & 3) >= valid)
        v[k] = -INFINITY;
    }
    float mx[C];
#pragma unroll
    for (int k = 0; k < C; ++k) mx[k] = v[k];
#pragma unroll
    for (int h = C / 2; h > 0; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) mx[k] = fmaxf(mx[k], mx[k + h]);
    const float rise = __fadd_rn(mx[0], cm[i]);
    if (__builtin_expect(rise > kTau, 0)) {      // the max rose: move m_ref
      s[i] *= ex2(-rise);
      mref[i] = __fadd_rn(mref[i], rise);
      cm[i] = -mref[i];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = ex2(__fadd_rn(v[k], cm[i]));
#pragma unroll
    for (int h = C / 2; h > 0; h >>= 1)
#pragma unroll
      for (int k = 0; k < h; ++k) v[k] += v[k + h];
    s[i] += v[0];
  }
}

// Grid (row blocks, column splits, members); members past gridDim.z loop.
// Member strides are in floats, 0 for an input every member shares.
template <class M>
__global__ void __launch_bounds__(kThreads, 2)
kde_lse_partial(const float* __restrict__ terms, const float* __restrict__ query,
                const float* __restrict__ bw, float* __restrict__ part_m,
                float* __restrict__ part_s, int q_rows, int n, int members,
                long long terms_stride, long long query_stride,
                long long bw_stride) {
  constexpr int R = M::kRows, TN = Shape<M>::kTile, CH = Shape<M>::kChunk;
  constexpr int T = M::kTerms, D = M::kDof;
  __shared__ __align__(16) float s_b[2][T * TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  const int col_begin = blockIdx.y * kSplitCols;
  const int col_end = min(n, col_begin + kSplitCols);

  for (int member = blockIdx.z; member < members; member += gridDim.z) {
    const float* tm = terms + member * terms_stride;
    const float* qm = query + member * query_stride;
    const float* bm = bw + member * bw_stride;
    float* pm = part_m + (static_cast<size_t>(member) * gridDim.y + blockIdx.y)
                             * q_rows;
    float* ps = part_s + (static_cast<size_t>(member) * gridDim.y + blockIdx.y)
                             * q_rows;

    __syncthreads();           // the previous member's last stage fully read
    stage_tile<M>(s_b[0], tm, n, col_begin, min(TN, col_end - col_begin));

    float w[D];
#pragma unroll
    for (int d = 0; d < D; ++d) w[d] = __fdiv_rn(kSqrtHalfLog2e, bm[d]);

    // m_ref starts at the row's own log2-weight at the split's first column
    float first[T];
#pragma unroll
    for (int k = 0; k < T; ++k)
      first[k] = tm[static_cast<size_t>(k) * n + col_begin];
    float r[R][M::kRowTerms], cm[R], mref[R], s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = min(row0 + i, q_rows - 1);   // rows past Q compute
      M::row(qm + static_cast<size_t>(row) * M::kPointDim, r[i]);  // junk
      mref[i] = M::pair(r[i], first, w, 0.f);
      cm[i] = -mref[i];
      s[i] = 0.f;
    }

    int buf = 0;
    for (int t0 = col_begin; t0 < col_end; t0 += TN, buf ^= 1) {
      const int tn = min(TN, col_end - t0);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();         // tile t0 visible, the other stage fully read
      if (t0 + TN < col_end)
        stage_tile<M>(s_b[buf ^ 1], tm, n, t0 + TN,
                      min(TN, col_end - t0 - TN));
      const float* sb = s_b[buf] + 4 * lane;
      const int full = tn / CH;
      for (int k = 0; k < full; ++k)
        consume_chunk<M, false>(sb + k * CH, lane, CH, r, w, cm, mref, s);
      if (tn - full * CH > 0)
        consume_chunk<M, true>(sb + full * CH, lane, tn - full * CH, r, w, cm,
                               mref, s);
    }

    // merge the 32 lanes of each row: max of m_ref, one rescale, sum
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float m = mref[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float t = s[i] * ex2(mref[i] - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      const int row = row0 + i;
      if (lane == 0 && row < q_rows) {
        pm[row] = m;
        ps[row] = t;
      }
    }
  }
}

// merge the column splits' (m, s) pairs (base 2) in split order and leave
// base e; one thread per row of the whole batch, partials laid out
// (members, splits, q_rows)
__global__ void kde_lse_combine(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                float* __restrict__ out, int q_rows,
                                int splits, int members) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= static_cast<size_t>(members) * q_rows) return;
  const size_t member = r / q_rows, row = r - member * q_rows;
  const float* pm = part_m + member * splits * q_rows + row;
  const float* ps = part_s + member * splits * q_rows + row;
  float mx = pm[0];
  for (int k = 1; k < splits; ++k)
    mx = fmaxf(mx, pm[static_cast<size_t>(k) * q_rows]);
  float sum = 0.f;
  for (int k = 0; k < splits; ++k)
    sum += ps[static_cast<size_t>(k) * q_rows] *
           exp2f(pm[static_cast<size_t>(k) * q_rows] - mx);
  out[r] = (mx + log2f(fmaxf(sum, 1e-30f))) * kLn2;
}

template <class M>
int launch(const float* points, const float* query, const float* bw,
           float* terms, float* part_m, float* part_s, float* out, int q_rows,
           int n, int members, int point_members, int query_members,
           int bw_members, cudaStream_t stream) {
  const long long prep = static_cast<long long>(point_members) * n;
  kde_lse_prep<M><<<static_cast<unsigned>((prep + 255) / 256), 256, 0,
                    stream>>>(points, terms, n, point_members);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = (n + kSplitCols - 1) / kSplitCols;
  const int rows = kWarps * M::kRows;
  const dim3 grid((q_rows + rows - 1) / rows, splits, members < 65535 ? members
                                                                      : 65535);
  kde_lse_partial<M><<<grid, kThreads, 0, stream>>>(
      terms, query, bw, part_m, part_s, q_rows, n, members,
      point_members == 1 ? 0LL : static_cast<long long>(M::kTerms) * n,
      query_members == 1 ? 0LL : static_cast<long long>(M::kPointDim) * q_rows,
      bw_members == 1 ? 0LL : static_cast<long long>(M::kDof));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(members) * q_rows;
  kde_lse_combine<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(part_m, part_s, out, q_rows, splits, members);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KDE_LSE_FOR_EACH_DOF(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" {

// Columns a split covers: the split count is ceil(n / this), for any query.
int kde_lse_split_cols() { return kSplitCols; }

// Floats a particle's terms take: the scratch `terms` holds
// point_members * this * n.  manifold 0 is Euclidean(dof), 1 is SE(2), 2 is
// SE(3).
int kde_lse_terms(int manifold, int dof) {
  if (manifold == 1) return dof == 3 ? SE2::kTerms : -1;
  if (manifold == 2) return dof == 6 ? SE3::kTerms : -1;
  if (manifold == 0 && dof >= 1 && dof <= 8) return dof;
  return -1;
}

// points (point_members, n, point_dim), query (query_members, q_rows,
// point_dim), bw (bw_members, dof), all float32 contiguous; each of the
// three holds 1 member (shared by all) or `members`.  terms is
// (point_members, kde_lse_terms, n) scratch, part_m and part_s are (members,
// ceil(n / kde_lse_split_cols()), q_rows) scratch, out is (members, q_rows).
// Returns cudaGetLastError() after the three launches (0 on success).
int kde_lse_launch(int manifold, int dof, const float* points,
                   const float* query, const float* bw, float* terms,
                   float* part_m, float* part_s, float* out, int q_rows, int n,
                   int members, int point_members, int query_members,
                   int bw_members, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (q_rows <= 0 || n <= 0 || members <= 0 ||
      (point_members != 1 && point_members != members) ||
      (query_members != 1 && query_members != members) ||
      (bw_members != 1 && bw_members != members))
    return static_cast<int>(cudaErrorInvalidValue);
  if (manifold == 1 && dof == 3)
    return launch<SE2>(points, query, bw, terms, part_m, part_s, out, q_rows,
                       n, members, point_members, query_members, bw_members,
                       stream);
  if (manifold == 2 && dof == 6)
    return launch<SE3>(points, query, bw, terms, part_m, part_s, out, q_rows,
                       n, members, point_members, query_members, bw_members,
                       stream);
  if (manifold != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dof) {
#define X(D)                                                               \
  case D:                                                                  \
    return launch<Euclid<D>>(points, query, bw, terms, part_m, part_s, out, \
                             q_rows, n, members, point_members,            \
                             query_members, bw_members, stream);
    KDE_LSE_FOR_EACH_DOF(X)
#undef X
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
