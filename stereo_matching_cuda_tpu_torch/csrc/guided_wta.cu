// K3: fused matching cost + guided-filter aggregation + streaming WTA,
// one view, in tiles, on Hopper (sm_90a).
//
// Replaces: stereo_matching_cuda_tpu/ops/pallas_guided.py::_make_kernel
//   (launched by _fused_tiles), the single view's tiled kernel, where each
//   (strip, tile) recomputes its y-halo.
// Checked against: stereo_matching_cuda_tpu_torch/ops/fused_guided.py::
//   guided_wta_fused_reference (cost_volume followed by guided_filter_wta),
//   at the fused fast-path bound (near-tie label flips only).
//
// What it computes, per output pixel (y, x) and slice s (d = dmin + s):
//   cost  = (1-a)*min(|I1 - I2(x+d)|, th_color) + a*min(|dI1 - dI2(x+d)|, th_grad),
//           2.5-class constant where x+d leaves [0, W), zero outside the image
//   mean_I, c = 1/(var + eps) (double), mean_p, mean_Ip over the clamped
//   (2R+1)^2 window; a, b zeroed outside the image; q = mean_a*I + mean_b;
//   if (best >= q) {best = q; dmap = d}   (ascending d: largest d wins ties)
// A (N, H, W) batch rides blockIdx.z (the TPU kernel's batched grid mode).
// The inputs may be tiles of a larger image, extended by a halo, with the
// global origin of their (0, 0) (Params in guided_common.cuh; the sharded
// path's ops/fused_guided.py::guided_wta_fused_local, as the TPU kernel's
// origin scalars): every coordinate, mask and window area is global.
//
// Design.  One CTA owns a TW x TH output tile and recomputes its 2R halo,
// as the TPU kernel's tiles do.  The CTA loads both uint8 input windows
// into shared memory once (the match window widened by the D-1 slice
// reach), computes the guide statistics over tile+R, then loops over the
// slices in ascending order.  Each slice builds the cost and I*cost over
// tile+2R in shared memory and reduces them with separable box sums:
// x-sums, y-sums to a and b, x-sums of a and b, y-sums to q.  Every pass
// takes runs of kRun = 8 adjacent windows a thread: the run's first window
// is summed directly and each next one adds the value that enters and
// subtracts the one that leaves (kept in registers from the first sum),
// so a run costs 2R + kRun loads and its float error grows by at most two
// roundings a window from a fresh sum.  Neither is an integral image
// (float32 cancellation at 6 MP).  The guide statistics stay integer
// sums, exact and equal to the plain version's bit for bit.  The last
// pass's runs go down the columns, one run of 8 output rows a thread, and
// that thread keeps (best, dmap) of its 8 pixels in registers across the
// slices; the other threads go on to the next slice's cost meanwhile.
// The window area is fixed per pixel, so each window takes one correctly
// rounded reciprocal of it (once per output, before the slice loop) and
// multiplies, where it divided twice.
//
// Bits do not depend on the tile.  Every run starts at a multiple of 8
// from the tile's own origin (outputs), or from the origin less R (the
// a/b region), and reads nothing left of that start.  Every tile width and
// height is a multiple of 8, so any CTA that computes a window of a frame
// (or of a tile whose interior starts on a multiple of 8, as the shard
// entry's x split at 6 MP does) sums it from the same run start, in the
// same order, whatever the tile shape: a batch, a split and every tile
// shape give the same bits (tests/test_torch_cuda.py).  The wrapper may
// therefore pick the tile from the frame's size (ops/_kernels.py).
//
// Tiles (guided_wta_launch below).  32 columns at 32, 16 or 8 rows run
// 512 threads (256 for 8 rows) at two CTAs per SM.  64 columns at 64, 56
// or 48 rows run 1024 threads at one CTA per SM: the halo ratio of the cost region,
// (TW + 4R)(TH + 4R) / (TW * TH), falls from 4.52 (32 x 32, R = 9) to 2.44
// (64 x 64), with the same 32 warps per SM.  A 64 x 64 tile at D = 16 takes
// ~223 KB of shared memory; above ~64 disparities the match window leaves
// room for 56 or 48 rows only.
//
// What bounds it on the H100.  Per output pixel and slice it issues about
// (2R + kRun) / kRun loads and 4 adds a window in each of the four box
// passes over two planes, scaled by each pass's halo ratio, plus the cost
// itself, against 2 bytes of input per pixel: it is bound by shared-memory
// latency and issue, not by device memory or float throughput.  Row
// pitches are odd, so a warp walking rows hits 32 banks.  K1
// (guided_wta_stream.cu) walks rows down a band instead and pays the y
// halo once per band.
//
// What each change measured (ms a launch at 1992 x 3008, D = 16; H100
// 80GB HBM3 at 700 W; scripts/torch_k3_tiles.py, PERF.md Findings).  The
// 32 x 32 kernel with the last pass direct and four divisions: 3.86.  The
// last pass in runs: 3.87 at 32 x 32, no gain, kept for bits that do not
// depend on the tile.  The reciprocal: 3.87 -> 3.61 at 32 x 32, 2.63 ->
// 2.47 at 64 x 64.  The 64-column tiles: 3.61 -> 2.47 (64 x 64) and 2.36
// (64 x 56, the 13 waves of 1,692 CTAs).  At 1988 x 2948, D = 128: 28.3 ->
// 17.1 (64 x 56).  A wave of 64 x 64 CTAs at one per SM takes 1.31 times
// one of 32 x 32 CTAs at two per SM and does twice the outputs, so a
// frame of a few waves takes the wide tile, and 288 x 384 (one partial
// wave) keeps 32 x 32 (0.131, where the previous kernel took 0.126).

#include "guided_common.cuh"

namespace {

using namespace guided;

// Geometry of one CTA's shared-memory windows.  Pitches are odd.
struct Geom {
  int P;        // 2R
  int ER, EC;   // cost region: tile + 2R on each side
  int MR, MC;   // a/b region: tile + R on each side
  int PE;       // pitch of the cost planes (>= EC)
  int PM;       // pitch of the x-sum planes and of a, b (>= MC)
  int I1C;      // guide window width: EC plus one column on each side
  int I2C;      // match window width: EC + D + 1
};

__host__ __device__ inline Geom geometry(int R, int TW, int TH, int D) {
  Geom g;
  g.P = 2 * R;
  g.ER = TH + 2 * g.P;
  g.EC = TW + 2 * g.P;
  g.MR = TH + g.P;
  g.MC = TW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.I1C = g.EC + 2;
  g.I2C = g.EC + D + 1;
  return g;
}

__host__ inline size_t smem_bytes(int R, int TW, int TH, int D) {
  const Geom g = geometry(R, TW, TH, D);
  const size_t floats = 2 * (size_t)g.ER * g.PE    // cost, I*cost; then a, b
                      + 2 * (size_t)g.ER * g.PM    // their x-sums; then a's, b's
                      + 2 * (size_t)g.MR * g.MC;   // mean_I, c
  const size_t bytes = (size_t)g.ER * g.I1C + (size_t)g.ER * g.I2C;
  return floats * sizeof(float) + bytes;
}

// f(r, c) for every cell of a rows x cols region, the cells dealt to the
// NT threads in row-major order (lanes on adjacent columns).
template <int NT, typename F>
__device__ inline void for_cells(int rows, int cols, int tid, F f) {
  const int dr = NT / cols, dc = NT % cols;
  int r = tid / cols, c = tid % cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// 1 / (clamped window area) at global (gy, gx), correctly rounded; `rk`
// is that of the unclamped area k * k, which every pixel at least R from
// the image's edges has.
__device__ inline float recip_area(int gy, int gx, int H, int W, int R, float rk) {
  const float area = window_area(gy, gx, H, W, R);
  const int k = 2 * R + 1;
  return area == (float)(k * k) ? rk : __frcp_rn(area);
}

// K3's guided coefficients from one window's sums of cost and I*cost and
// the reciprocal of its area (guided_common.cuh's guided_ab divides; K1,
// K4 and K5 keep it).  Rounded explicitly, so every tile computes the
// same bits.
__device__ inline void guided_ab_recip(float s1, float s2, float r, float mean_i, float c,
                                       float& a, float& b) {
  const float mp = __fmul_rn(s1, r), mip = __fmul_rn(s2, r);
  a = __fmul_rn(__fmaf_rn(-mean_i, mp, mip), c);
  b = __fmaf_rn(-mean_i, a, mp);
}

template <int TW, int TH, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
guided_wta_kernel(const uint8_t* __restrict__ gray1,
                  const uint8_t* __restrict__ gray2,
                  float* __restrict__ best_out,
                  float* __restrict__ dmap_out, Params p) {
  static_assert(TW % kRun == 0 && TH % kRun == 0, "runs must tile the outputs");
  constexpr int kQ = TW * (TH / kRun);  // threads of the last pass: one run each
  static_assert(kQ <= NT, "one run of outputs a thread");
  constexpr int QP = TW + 1;            // pitch of the x-sums of a and b
  extern __shared__ float smem[];
  const Geom g = geometry(p.R, TW, TH, p.D);
  const int P = g.P, R = p.R, H = p.H, W = p.W;
  const int k = 2 * R + 1;
  float* buf1a = smem;                       // cost      -> a
  float* buf1b = buf1a + g.ER * g.PE;        // I*cost    -> b
  float* buf2a = buf1b + g.ER * g.PE;        // xsum(cost)   -> xsum(a)
  float* buf2b = buf2a + g.ER * g.PM;        // xsum(I*cost) -> xsum(b)
  float* mean_i = buf2b + g.ER * g.PM;
  float* c_i = mean_i + g.MR * g.MC;
  uint8_t* i1s = reinterpret_cast<uint8_t*>(c_i + g.MR * g.MC);
  uint8_t* i2s = i1s + g.ER * g.I1C;

  const int tid = threadIdx.x;
  gray1 += (size_t)blockIdx.z * p.Hb * p.Wb;
  gray2 += (size_t)blockIdx.z * p.Hb * p.Wb;
  best_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  dmap_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  // Global coordinates from here on: the tile's interior starts at
  // (iy, ix), and the outputs end at (yend, xend).
  const int x0 = p.ix + blockIdx.x * TW, y0 = p.iy + blockIdx.y * TH;
  const int yend = p.iy + p.Hi, xend = p.ix + p.Wi;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the E region
  const int ym = y0 - R, xm = x0 - R;        // global origin of the M region
  const float rk = __frcp_rn((float)(k * k));

  // Input windows, zero outside the image (and the buffer).  i1s column
  // c holds global column xe - 1 + c; i2s column c holds xe + dmin - 1 + c.
  for_cells<NT>(g.ER, g.I1C, tid, [&](int r, int c) {
    i1s[r * g.I1C + c] = buffer_px(gray1, ye + r, xe - 1 + c, p);
  });
  for_cells<NT>(g.ER, g.I2C, tid, [&](int r, int c) {
    i2s[r * g.I2C + c] = buffer_px(gray2, ye + r, xe + p.dmin - 1 + c, p);
  });
  __syncthreads();

  // Guide statistics over M: integer x-sums (exact in float), y-sums in
  // double, rounded once (see guide_stats).
  for_cells<NT>(g.ER, g.EC, tid, [&](int r, int c) {
    const float v = (float)i1s[r * g.I1C + c + 1];
    buf1a[r * g.PE + c] = v;
    buf1b[r * g.PE + c] = v * v;
  });
  __syncthreads();
  x_sums<float, NT>(buf1a, buf1b, g.PE, buf2a, buf2b, g.PM, g.ER, g.MC, k, tid);
  __syncthreads();
  {
    const int nblk = (g.MR + kRB - 1) / kRB;
    for (int t = tid; t < g.MC * nblk; t += NT) {
      const int c = t % g.MC, r0 = (t / g.MC) * kRB;
      const int nv = min(kRB, g.MR - r0);
      double s1[kRB], s2[kRB];
      window_sums<kRB>(buf2a + r0 * g.PM + c, g.PM, k, nv, s1);
      window_sums<kRB>(buf2b + r0 * g.PM + c, g.PM, k, nv, s2);
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (i >= nv) break;
        const int gy = ym + r0 + i, gx = xm + c;
        float m = 0.f, cc = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          guide_stats(s1[i], s2[i], window_area(gy, gx, H, W, R), p.eps, m, cc);
        mean_i[(r0 + i) * g.MC + c] = m;
        c_i[(r0 + i) * g.MC + c] = cc;
      }
    }
  }
  __syncthreads();

  // The last pass's threads are the block's last kQ: the first ones take
  // the extra cells of the cost pass.  Thread tq's run is output column
  // cq, rows yq .. yq + kRun - 1.
  const int tq = tid - (NT - kQ);
  const int cq = tq % TW, yq = (tq / TW) * kRun;
  float best[kRun], dmap[kRun], rq[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    best[i] = best_init();
    dmap[i] = 0.f;
    rq[i] = recip_area(y0 + yq + i, x0 + cq, H, W, R, rk);
  }

  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;

    // 1. cost and I*cost over E (zero outside the image).
    for_cells<NT>(g.ER, g.EC, tid, [&](int r, int c) {
      const int gy = ye + r, gx = xe + c;
      float cost = 0.f, iv = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint8_t* q1 = i1s + r * g.I1C + c + 1;   // q1[0] at gx
        iv = (float)q1[0];
        const int gx2 = gx + d;
        cost = (gx2 < 0 || gx2 >= W)
                   ? p.oob
                   : raw_cost(q1, gx, i2s + r * g.I2C + c + s + 1, gx2, p);
      }
      buf1a[r * g.PE + c] = cost;
      buf1b[r * g.PE + c] = iv * cost;
    });
    __syncthreads();

    // 2. x-window sums over (E rows) x (M columns), in runs.
    x_runs<NT>(buf1a, buf1b, g.PE, buf2a, buf2b, g.PM, g.ER, g.MC, k, tid);
    __syncthreads();

    // 3. y-window sums in runs down a column (lanes on adjacent columns)
    // -> mean_p, mean_Ip -> a, b over M (into buf1).
    {
      const int nrun = (g.MR + kRun - 1) / kRun;
      for (int t = tid; t < g.MC * nrun; t += NT) {
        const int c = t % g.MC, r0 = (t / g.MC) * kRun;
        const float* pa = buf2a + r0 * g.PM + c;
        const float* pb = buf2b + r0 * g.PM + c;
        run_sums<kRun>(
            [&](int j) { return pa[j * g.PM]; }, [&](int j) { return pb[j * g.PM]; }, k,
            min(kRun, g.MR - r0), [&](int i, float s1, float s2) {
              const int r = r0 + i, gy = ym + r, gx = xm + c;
              float a = 0.f, b = 0.f;
              if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                guided_ab_recip(s1, s2, recip_area(gy, gx, H, W, R, rk),
                                mean_i[r * g.MC + c], c_i[r * g.MC + c], a, b);
              buf1a[r * g.PM + c] = a;
              buf1b[r * g.PM + c] = b;
            });
      }
    }
    __syncthreads();

    // 4. x-window sums of a, b over (M rows) x (tile columns) (into
    // buf2), in runs.
    x_runs<NT>(buf1a, buf1b, g.PM, buf2a, buf2b, QP, g.MR, TW, k, tid);
    __syncthreads();

    // 5. y-window sums in runs down the column -> q -> streaming WTA in
    // registers.  The next slice's step 1 writes buf1 only, so no barrier
    // is needed here, and the other threads start it at once; its step 2
    // writes buf2 after the barrier that ends step 1.
    if (tq >= 0) {
      const float* pa = buf2a + yq * QP + cq;
      const float* pb = buf2b + yq * QP + cq;
      const uint8_t* iq = i1s + (yq + P) * g.I1C + cq + P + 1;
      run_sums<kRun>(
          [&](int j) { return pa[j * QP]; }, [&](int j) { return pb[j * QP]; }, k, kRun,
          [&](int i, float sa, float sb) {
            const float q = __fmul_rn(__fmaf_rn(sa, (float)iq[i * g.I1C], sb), rq[i]);
            if (best[i] >= q) {
              best[i] = q;
              dmap[i] = (float)d;
            }
          });
    }
  }

  if (tq >= 0) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int gy = y0 + yq + i, gx = x0 + cq;
      if (gy < yend && gx < xend) {
        const size_t at = (size_t)(gy - p.iy) * p.Wi + (gx - p.ix);
        best_out[at] = best[i];
        dmap_out[at] = dmap[i];
      }
    }
  }
}

template <int TW, int TH, int NT, int MINB>
cudaError_t launch(const uint8_t* gray1, const uint8_t* gray2, float* best,
                   float* dmap, int N, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.R, TW, TH, p.D);
  auto* kernel = guided_wta_kernel<TW, TH, NT, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Wi + TW - 1) / TW, (p.Hi + TH - 1) / TH, N);
  kernel<<<grid, NT, smem, stream>>>(gray1, gray2, best, dmap, p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for a given radius, tile width
// and height and slice count (bytes).  The wrapper picks the tile with it.
extern "C" long long guided_wta_smem_bytes(int R, int TW, int TH, int D) {
  return (long long)smem_bytes(R, TW, TH, D);
}

// Launches K3 on `stream`.  gray1/gray2: uint8 (N, Hb, Wb) contiguous,
// tiles of an H x W image whose (0, 0) is at global (oy, ox); best/dmap:
// float32 (N, Hi, Wi), the interior at offset (hy, hx) in the tile (see
// Params; a whole frame is Hb = Hi = H, Wb = Wi = W, the rest 0).  The
// output tile TW x TH must be 32 x 32, 32 x 16, 32 x 8, 64 x 64, 64 x 56 or
// 64 x 48.  Returns the CUDA error of the launch (0 on success).
extern "C" int guided_wta_launch(const void* gray1, const void* gray2,
                                 void* best, void* dmap, int N, int H, int W,
                                 int Hb, int Wb, int oy, int ox, int hy, int hx,
                                 int Hi, int Wi, int dmin, int D, int R, int TW,
                                 int TH, float one_m_alpha, float alpha,
                                 float th_color, float th_grad, float oob,
                                 double eps, void* stream) {
  Params p = make_params(H, W, dmin, D, R, one_m_alpha, alpha, th_color,
                         th_grad, oob, eps);
  set_tile(p, Hb, Wb, oy, ox, hy, hx, Hi, Wi);
  const auto* g1 = static_cast<const uint8_t*>(gray1);
  const auto* g2 = static_cast<const uint8_t*>(gray2);
  auto* b = static_cast<float*>(best);
  auto* m = static_cast<float*>(dmap);
  auto st = static_cast<cudaStream_t>(stream);
  switch (TW * 1000 + TH) {
    case 32032: return (int)launch<32, 32, 512, 2>(g1, g2, b, m, N, p, st);
    case 32016: return (int)launch<32, 16, 512, 2>(g1, g2, b, m, N, p, st);
    case 32008: return (int)launch<32, 8, 256, 2>(g1, g2, b, m, N, p, st);
    case 64064: return (int)launch<64, 64, 1024, 1>(g1, g2, b, m, N, p, st);
    case 64056: return (int)launch<64, 56, 1024, 1>(g1, g2, b, m, N, p, st);
    case 64048: return (int)launch<64, 48, 1024, 1>(g1, g2, b, m, N, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
