// Device code shared by the guided-filter matching kernels: K3
// (guided_wta.cu, one view, tiled), K1 (guided_wta_stream.cu, one view,
// row walk) and the dual-view kernels K4
// (guided_wta_dual.cu) and K5 (guided_wta_dual_stream.cu), which compute
// the left and the right view's matching in one pass, from one raw cost
// slice per disparity.
//
// Window sums.  The guide statistics of every kernel, the last y-pass of
// K3 and K4 and K1's y-pass to a/b sum each window directly
// (window_sums, x_sums).  The other per-slice box passes of K3 and K4,
// passes 3-6 of K5 and passes 2, 4 and 5 of K1 sum runs of kRun windows
// from one direct seed (run_sums, x_runs, run_sums1).
//
// Dual-view kernels.  The raw slice.  For left label d the truncated AD + gradient cost at
// global column x is raw(x) = F(I_l(x), I_r(x + d)).  The right view's
// label -d at column x reads the same slice at x - d:
//   cost_R(x, -d) = F(I_r(x), I_l(x - d)) = raw(x - d)
// (F is symmetric in its two pixels), so a CTA computes raw once over the
// union of both views' columns and each view masks it with its own
// in-image and match-in-range tests.  Window widths follow from the
// column reach pos + neg, pos = max(0, d_max), neg = max(0, -d_min)
// (the JAX package's dual_geometry).
//
// Window layout.  A CTA's output columns start at x0; its cost region E
// starts at xe = x0 - 2R and is EC = 32 + 4R wide.  The left window's
// column c holds global column xe - 1 - pos + c, the right window's
// xe - 1 - neg + c; both are WC = EC + 2 + pos + neg wide (one extra
// column on each side for the derivative).  The raw slice's column j
// holds global column xe - pos + j, j < EC + pos + neg.
//
// Tie rules.  Both kernels walk the left labels ascending: the left view
// updates on best >= q (the largest label wins ties, as the reference's
// streaming WTA); its labels d_r = -d then descend, so the right view
// updates on strict best > q to keep the largest d_r on a tie.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace guided {

constexpr int kTileW = 32;       // output columns per CTA: one warp
constexpr int kBlockY = 8;       // the block is kTileW x kBlockY threads
constexpr int kThreads = kTileW * kBlockY;
constexpr int kRB = 4;           // adjacent windows one thread sums at once
// Windows per run of the sliding box passes: float runs of 8 beat 4, 12
// and 16 and runs added in double on K3 (PERF.md, Findings: K3, K4
// and K5 redesigned).
constexpr int kRun = 8;

// Block height of a TH-row tile (K3, K4): 16 (512 threads, two CTAs and
// 32 warps per SM) where the tile has the rows, else 8.
__host__ __device__ constexpr int block_rows(int TH) { return TH >= 16 ? 16 : 8; }

// Tiles with an origin (K1, K3).  H, W are the global image's.  The input
// buffers are Hb x Wb frames whose (0, 0) is global (oy, ox): a tile of
// the image extended by a halo.  A read at global (gy, gx) is zero outside
// the image, and also outside the buffer (such pixels are read only for
// outputs outside the interior: the wrapper checks that the halo covers
// the kernel's reach).  The grid covers the interior, Hi x Wi at global
// (iy, ix), and the outputs are Hi x Wi frames.  A whole frame is origin
// 0 with buffer = interior = image (make_params).
struct Params {
  int H, W, dmin, D, R;
  int pos, neg;                  // max(0, d_max), max(0, -d_min) (dual kernels)
  float one_m_alpha, alpha, th_color, th_grad, oob;
  double eps;
  int Hb, Wb, oy, ox;            // input buffer: size and global origin
  int ry0, ry1, cx0, cx1;        // global rows / columns in the image and the buffer
  int iy, ix, Hi, Wi;            // interior: global origin and size
};

__host__ inline Params make_params(int H, int W, int dmin, int D, int R,
                                   float one_m_alpha, float alpha,
                                   float th_color, float th_grad, float oob,
                                   double eps) {
  const int dmax = dmin + D - 1;
  return Params{H, W, dmin, D, R, dmax > 0 ? dmax : 0, dmin < 0 ? -dmin : 0,
                one_m_alpha, alpha, th_color, th_grad, oob, eps,
                H, W, 0, 0, 0, H, 0, W, 0, 0, H, W};
}

// The buffer (Hb x Wb, its (0, 0) at global (oy, ox)) and the interior
// (Hi x Wi at offset (hy, hx) in the buffer) of a tile.
__host__ inline void set_tile(Params& p, int Hb, int Wb, int oy, int ox, int hy,
                              int hx, int Hi, int Wi) {
  p.Hb = Hb;
  p.Wb = Wb;
  p.oy = oy;
  p.ox = ox;
  p.ry0 = oy > 0 ? oy : 0;
  p.ry1 = oy + Hb < p.H ? oy + Hb : p.H;
  p.cx0 = ox > 0 ? ox : 0;
  p.cx1 = ox + Wb < p.W ? ox + Wb : p.W;
  p.iy = oy + hy;
  p.ix = ox + hx;
  p.Hi = Hi;
  p.Wi = Wi;
}

// Input pixel at global (gy, gx) of one frame of a tile's buffer (see
// Params), zero outside the image and the buffer.
__device__ inline uint8_t buffer_px(const uint8_t* __restrict__ buf, int gy, int gx,
                                    const Params& p) {
  return (gy >= p.ry0 && gy < p.ry1 && gx >= p.cx0 && gx < p.cx1)
             ? buf[(size_t)(gy - p.oy) * p.Wb + (gx - p.ox)]
             : (uint8_t)0;
}

// out[i] = at(i) + ... + at(i + k - 1) for i < nv <= RB.  The RB windows
// share values RB-1 .. k-1, summed once as `mid`; then
// out[i] = (v_i + ... + v_{RB-2}) + mid + (v_k + ... + v_{k+i-1}).
// Needs k >= RB - 1.  Reads nothing past window nv - 1.
template <int RB, typename Acc, typename Load>
__device__ inline void window_sums(Load at, int k, int nv, Acc (&out)[RB]) {
  Acc mid = 0;
  for (int j = RB - 1; j < k; ++j) mid += at(j);
  Acc head[RB];
  head[RB - 1] = 0;
#pragma unroll
  for (int i = RB - 2; i >= 0; --i) head[i] = head[i + 1] + at(i);
  Acc tail = 0;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    out[i] = head[i] + mid + tail;
    if (i + 1 < nv) tail += at(k + i);
  }
}

// The same over src[0], src[stride], src[2 * stride], ...: K3 and K4 ran
// faster on this form, K5 on the loader form (PERF.md, Findings: the
// port and what it taught).
template <int RB, typename Acc>
__device__ inline void window_sums(const float* __restrict__ src, int stride,
                                   int k, int nv, Acc (&out)[RB]) {
  Acc mid = 0;
  for (int j = RB - 1; j < k; ++j) mid += src[j * stride];
  Acc head[RB];
  head[RB - 1] = 0;
#pragma unroll
  for (int i = RB - 2; i >= 0; --i) head[i] = head[i + 1] + src[i * stride];
  Acc tail = 0;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    out[i] = head[i] + mid + tail;
    if (i + 1 < nv) tail += src[(k + i) * stride];
  }
}

// x-window sums of two planes: dst[r][c] = sum_j src[r][c + j] for
// r < rows, c < cols.  Lanes walk rows (odd pitches: no bank conflicts).
// NT: the block's thread count.
template <typename Acc, int NT = kThreads>
__device__ inline void x_sums(const float* a, const float* b, int src_pitch,
                              float* da, float* db, int dst_pitch,
                              int rows, int cols, int k, int tid) {
  const int nblk = (cols + kRB - 1) / kRB;
  for (int t = tid; t < rows * nblk; t += NT) {
    const int r = t % rows, c0 = (t / rows) * kRB;
    const int nv = min(kRB, cols - c0);
    Acc s1[kRB], s2[kRB];
    window_sums<kRB>(a + r * src_pitch + c0, 1, k, nv, s1);
    window_sums<kRB>(b + r * src_pitch + c0, 1, k, nv, s2);
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      if (i < nv) {
        da[r * dst_pitch + c0 + i] = (float)s1[i];
        db[r * dst_pitch + c0 + i] = (float)s2[i];
      }
  }
}

// x-window sums of two planes: da[r][c] = sum_j la(r, c + j) for r < rows,
// c < cols.  Lanes walk rows (odd pitches: no bank conflicts).
template <typename Acc, int NT, typename LA, typename LB>
__device__ inline void x_sums(LA la, LB lb, float* da, float* db, int dst_pitch,
                              int rows, int cols, int k, int tid) {
  const int nblk = (cols + kRB - 1) / kRB;
  for (int t = tid; t < rows * nblk; t += NT) {
    const int r = t % rows, c0 = (t / rows) * kRB;
    const int nv = min(kRB, cols - c0);
    Acc s1[kRB], s2[kRB];
    window_sums<kRB>([&](int j) { return la(r, c0 + j); }, k, nv, s1);
    window_sums<kRB>([&](int j) { return lb(r, c0 + j); }, k, nv, s2);
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      if (i < nv) {
        da[r * dst_pitch + c0 + i] = (float)s1[i];
        db[r * dst_pitch + c0 + i] = (float)s2[i];
      }
  }
}

// One run of S adjacent windows of k values over two planes: window i
// is a(i) + ... + a(i + k - 1) (and the same of b), for i < nv <= S.
// The first window is summed directly; each next one adds the value that
// enters and subtracts the one that leaves, which (for S - 1 <= k) is one
// of the first window's own values, kept in registers.  So a run costs
// k + S - 1 loads and k - 1 + 2(S - 1) adds per plane, and its error
// grows by at most two roundings a window from a fresh direct sum.
// emit(i, sum_a, sum_b) takes each window.  Reads nothing past window
// nv - 1.  Where emit ignores sum_b, the compiler drops plane b.
template <int S, typename LA, typename LB, typename Emit>
__device__ inline void run_sums(LA a, LB b, int k, int nv, Emit emit) {
  float la[S], lb[S];                   // the values that leave: j < S - 1
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    const bool need = j < k || j + 1 < nv;
    la[j] = need ? a(j) : 0.f;
    lb[j] = need ? b(j) : 0.f;
    if (j < k) {
      sa += la[j];
      sb += lb[j];
    }
  }
  for (int j = S - 1; j < k; ++j) {
    sa += a(j);
    sb += b(j);
  }
  emit(0, sa, sb);
#pragma unroll
  for (int i = 1; i < S; ++i) {
    if (i >= nv) break;
    sa += a(k + i - 1) - la[i - 1];
    sb += b(k + i - 1) - lb[i - 1];
    emit(i, sa, sb);
  }
}

// The sum of one plane's run: run_sums over a plane of zeros beside it,
// whose sums the compiler drops.  The passes of the row walks (K1, K5)
// that take one plane per task use it, to keep their task counts up.
template <typename L, typename Emit>
__device__ inline void run_sums1(L a, int k, int nv, Emit emit) {
  run_sums<kRun>(a, [](int) { return 0.f; }, k, nv,
                 [&](int i, float sa, float) { emit(i, sa); });
}

// x-window sums of two planes in runs of kRun: dst[r][c] = sum_j
// src[r][c + j] for r < rows, c < cols.  Lanes walk rows (odd pitches:
// no bank conflicts).
template <int NT>
__device__ inline void x_runs(const float* a, const float* b, int src_pitch,
                              float* da, float* db, int dst_pitch,
                              int rows, int cols, int k, int tid) {
  const int nrun = (cols + kRun - 1) / kRun;
  for (int t = tid; t < rows * nrun; t += NT) {
    const int r = t % rows, c0 = (t / rows) * kRun;
    const float* pa = a + r * src_pitch + c0;
    const float* pb = b + r * src_pitch + c0;
    float* qa = da + r * dst_pitch + c0;
    float* qb = db + r * dst_pitch + c0;
    run_sums<kRun>([&](int j) { return pa[j]; }, [&](int j) { return pb[j]; },
                   k, min(kRun, cols - c0), [&](int i, float sa, float sb) {
                     qa[i] = sa;
                     qb[i] = sb;
                   });
  }
}

// Clamped window area (guidedFilter.cu:314-317) at global (gy, gx).
__device__ inline float window_area(int gy, int gx, int H, int W, int R) {
  const int ay = min(H - 1, gy + R) - max(-1, gy - R - 1);
  const int ax = min(W - 1, gx + R) - max(-1, gx - R - 1);
  return (float)(ay * ax);
}

// Negated central difference at a window position whose global column
// is gx; one-sided at the image's own edges (costVolume.cu:362-378).
__device__ inline float x_derivative(const uint8_t* p, int gx, int W) {
  const int mid = p[0];
  const int right = gx < W - 1 ? p[1] : mid;
  const int left = gx > 0 ? p[-1] : mid;
  return (float)(left - right) * 0.5f;
}

// Raw truncated AD + gradient cost: q1 points at I_l(gx1), q2 at
// I_r(gx2) in their windows.  Rounded as the plain version rounds it.
__device__ inline float raw_cost(const uint8_t* q1, int gx1, const uint8_t* q2,
                                 int gx2, const Params& p) {
  const float diff = (float)abs((int)q1[0] - (int)q2[0]);
  const float grad = fabsf(x_derivative(q1, gx1, p.W) - x_derivative(q2, gx2, p.W));
  return __fadd_rn(__fmul_rn(p.one_m_alpha, fminf(diff, p.th_color)),
                   __fmul_rn(p.alpha, fminf(grad, p.th_grad)));
}

// mean_I and c = fl32(1 / (f64 var + f64 eps)) from the window sums of I
// and I^2.  I and I^2 are integers: their x-sums (< 2^24 for any radius
// whose tile fits shared memory) are exact in float and the y-sums exact
// in double, in any order, so each window sum is rounded once, as the
// plain version's float64 box sums are, and the statistics match it bit
// for bit.
__device__ inline void guide_stats(double s1, double s2, float area, double eps,
                                   float& mean, float& c) {
  mean = __fdiv_rn((float)s1, area);
  const float var = __fsub_rn(__fdiv_rn((float)s2, area), __fmul_rn(mean, mean));
  c = (float)(1.0 / ((double)var + eps));
}

// Guided coefficients from one window's sums of cost and I*cost.
__device__ inline void guided_ab(float s1, float s2, float area, float mean_i,
                                 float c, float& a, float& b) {
  const float mp = s1 / area, mip = s2 / area;
  a = (mip - mean_i * mp) * c;
  b = mp - mean_i * a;
}

__device__ inline float best_init() { return __int_as_float(0x7F7F7F7F); }  // main.cu:112-115

}  // namespace guided
