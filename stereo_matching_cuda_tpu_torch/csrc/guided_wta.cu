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
// A (N, H, W) batch rides blockIdx.z (the TPU kernel's batched grid mode);
// the tile height does not depend on N, so each frame of a batch is
// computed as a lone launch computes it, bit for bit.  The inputs may be
// tiles of a larger image, extended by a halo, with the global origin
// of their (0, 0) (Params in guided_common.cuh; the sharded path's
// ops/fused_guided.py::guided_wta_fused_local, as the TPU kernel's
// origin scalars): every coordinate, mask and window area is global,
// so a CTA whose output columns and rows are the same global ones
// computes the same bits as in a whole-frame launch.
//
// Design.  One CTA owns a 32 x TH output tile and recomputes its 2R halo,
// as the TPU kernel's tiles do.  The CTA loads both uint8 input
// windows into shared memory once (the match window widened by the D-1
// slice reach), computes the guide statistics over tile+R, then loops over
// the slices in ascending order.  Each slice builds the cost and I*cost
// over tile+2R in shared memory and reduces them with separable box sums:
// x-sums, y-sums to a and b, x-sums of a and b, y-sums to q.  The first
// three passes take runs of kRun = 8 adjacent windows a thread: the run's
// first window is summed directly and each next one adds the value that
// enters and subtracts the one that leaves (kept in registers from the
// first sum), so a run costs 2R + kRun loads and its float error grows by
// at most two roundings a window from a fresh sum (PR 1's running sums
// drifted because they were never reseeded).  The last pass is each
// thread's own TH/16 rows, summed directly (a run of 2 costs the same).
// Neither is an integral image (float32 cancellation at 6 MP).  The
// guide statistics stay integer sums, exact and equal to the plain
// version's bit for bit.  Each thread keeps (best, dmap) of its rows in
// registers across slices.
//
// Block and tile.  A 16- or 32-row tile runs 32 x 16 = 512 threads at
// __launch_bounds__(512, 2): two CTAs, 32 warps, per SM (at most 64
// registers a thread).  An 8-row tile, which radii above 20 need for
// shared memory, keeps 32 x 8 threads.  The wrapper takes the tile that
// fits the most CTAs per SM, then the tallest (ops/_kernels.py).
//
// What bounds it on the H100.  Per output pixel and slice it issues four
// box passes over two planes (about (2R + kRun)/kRun loads and 4 adds a
// window in the first three), scaled by the tile's halo ratio
// ((32+4R)(TH+4R)/(32*TH) for the cost: 4.5 at R = 9, TH = 32), plus the
// cost itself, against 2 bytes of input per pixel: it is bound by
// shared-memory latency and issue, not by device memory or float
// throughput.  Row pitches are odd, so a warp walking rows hits 32 banks.
// K1 (guided_wta_stream.cu) walks rows down a band instead and pays the
// y halo once per band.
//
// What each redesign stage changed (PERF.md, Findings: K3, K4 and K5
// redesigned).  Stage 1: 32 x 16 blocks instead of 32 x 8, twice the warps
// per SM (-15% at 6 MP); the 16-row tile that would give a 288x384 frame a
// CTA per SM ran slower than the 32-row one, so the tile stays
// tallest-first.  Stage 2, derivatives cached per tile, ran 5-9% slower
// and was reverted: its int16 caches fit beside two CTAs per SM only with
// I*cost formed in the x-pass at every read.  Stage 3: the runs above
// (-17% at 6 MP).

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

__host__ __device__ inline Geom geometry(int R, int TH, int D) {
  Geom g;
  g.P = 2 * R;
  g.ER = TH + 2 * g.P;
  g.EC = kTileW + 2 * g.P;
  g.MR = TH + g.P;
  g.MC = kTileW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.I1C = g.EC + 2;
  g.I2C = g.EC + D + 1;
  return g;
}

__host__ inline size_t smem_bytes(int R, int TH, int D) {
  const Geom g = geometry(R, TH, D);
  const size_t floats = 2 * (size_t)g.ER * g.PE    // cost, I*cost; then a, b
                      + 2 * (size_t)g.ER * g.PM    // their x-sums; then a's, b's
                      + 2 * (size_t)g.MR * g.MC;   // mean_I, c
  const size_t bytes = (size_t)g.ER * g.I1C + (size_t)g.ER * g.I2C;
  return floats * sizeof(float) + bytes;
}

template <int TH, int BY>
__global__ void __launch_bounds__(kTileW * BY, 2)
guided_wta_kernel(const uint8_t* __restrict__ gray1,
                  const uint8_t* __restrict__ gray2,
                  float* __restrict__ best_out,
                  float* __restrict__ dmap_out, Params p) {
  constexpr int NT = kTileW * BY;       // threads of the block
  constexpr int kRows = TH / BY;        // output rows per thread
  extern __shared__ float smem[];
  const Geom g = geometry(p.R, TH, p.D);
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

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  gray1 += (size_t)blockIdx.z * p.Hb * p.Wb;
  gray2 += (size_t)blockIdx.z * p.Hb * p.Wb;
  best_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  dmap_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  // Global coordinates from here on: the tile's interior starts at
  // (iy, ix), and the outputs end at (yend, xend).
  const int x0 = p.ix + blockIdx.x * kTileW, y0 = p.iy + blockIdx.y * TH;
  const int yend = p.iy + p.Hi, xend = p.ix + p.Wi;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the E region
  const int ym = y0 - R, xm = x0 - R;        // global origin of the M region

  // Input windows, zero outside the image (and the buffer).  i1s column
  // c holds global column xe - 1 + c; i2s column c holds xe + dmin - 1 + c.
  for (int r = ty; r < g.ER; r += BY) {
    const int gy = ye + r;
    for (int c = tx; c < g.I1C; c += kTileW)
      i1s[r * g.I1C + c] = buffer_px(gray1, gy, xe - 1 + c, p);
    for (int c = tx; c < g.I2C; c += kTileW)
      i2s[r * g.I2C + c] = buffer_px(gray2, gy, xe + p.dmin - 1 + c, p);
  }
  __syncthreads();

  // Guide statistics over M: integer x-sums (exact in float), y-sums in
  // double, rounded once (see guide_stats).
  for (int r = ty; r < g.ER; r += BY)
    for (int c = tx; c < g.EC; c += kTileW) {
      const float v = (float)i1s[r * g.I1C + c + 1];
      buf1a[r * g.PE + c] = v;
      buf1b[r * g.PE + c] = v * v;
    }
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

  float best[kRows], dmap[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    best[i] = best_init();
    dmap[i] = 0.f;
  }
  const int yq = ty * kRows;                 // this thread's first output row

  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;

    // 1. cost and I*cost over E (zero outside the image).
    for (int r = ty; r < g.ER; r += BY) {
      const int gy = ye + r;
      for (int c = tx; c < g.EC; c += kTileW) {
        const int gx = xe + c;
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
      }
    }
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
                guided_ab(s1, s2, window_area(gy, gx, H, W, R), mean_i[r * g.MC + c],
                          c_i[r * g.MC + c], a, b);
              buf1a[r * g.PM + c] = a;
              buf1b[r * g.PM + c] = b;
            });
      }
    }
    __syncthreads();

    // 4. x-window sums of a, b over (M rows) x (tile columns) (into
    // buf2), in runs.
    x_runs<NT>(buf1a, buf1b, g.PM, buf2a, buf2b, kTileW + 1, g.MR, kTileW, k, tid);
    __syncthreads();

    // 5. y-window sums -> q -> streaming WTA in registers, rows yq ..
    // yq + kRows - 1 of column tx.  The next slice's step 1 writes buf1
    // only, so no barrier is needed here; its step 2 writes buf2 after
    // the barrier that ends step 1.
    {
      float sa[kRows], sb[kRows];
      window_sums<kRows>(buf2a + yq * (kTileW + 1) + tx, kTileW + 1, k, kRows, sa);
      window_sums<kRows>(buf2b + yq * (kTileW + 1) + tx, kTileW + 1, k, kRows, sb);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int gy = y0 + yq + i, gx = x0 + tx;
        if (gy < yend && gx < xend) {
          const float area = window_area(gy, gx, H, W, R);
          const float iv = (float)i1s[(yq + i + P) * g.I1C + tx + P + 1];
          const float q = (sa[i] / area) * iv + sb[i] / area;
          if (best[i] >= q) {
            best[i] = q;
            dmap[i] = (float)d;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gy = y0 + yq + i, gx = x0 + tx;
    if (gy < yend && gx < xend) {
      const size_t at = (size_t)(gy - p.iy) * p.Wi + (gx - p.ix);
      best_out[at] = best[i];
      dmap_out[at] = dmap[i];
    }
  }
}

template <int TH>
cudaError_t launch(const uint8_t* gray1, const uint8_t* gray2, float* best,
                   float* dmap, int N, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.R, TH, p.D);
  constexpr int BY = block_rows(TH);
  cudaError_t err = cudaFuncSetAttribute(
      guided_wta_kernel<TH, BY>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Wi + kTileW - 1) / kTileW, (p.Hi + TH - 1) / TH, N);
  guided_wta_kernel<TH, BY><<<grid, dim3(kTileW, BY), smem, stream>>>(
      gray1, gray2, best, dmap, p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for a given radius, tile height
// and slice count (bytes).  The wrapper picks the tile height with it.
extern "C" long long guided_wta_smem_bytes(int R, int TH, int D) {
  return (long long)smem_bytes(R, TH, D);
}

// Launches K3 on `stream`.  gray1/gray2: uint8 (N, Hb, Wb) contiguous,
// tiles of an H x W image whose (0, 0) is at global (oy, ox); best/dmap:
// float32 (N, Hi, Wi), the interior at offset (hy, hx) in the tile (see
// Params; a whole frame is Hb = Hi = H, Wb = Wi = W, the rest 0).  TH must
// be 8, 16 or 32.  Returns the CUDA error of the launch (0 on success).
extern "C" int guided_wta_launch(const void* gray1, const void* gray2,
                                 void* best, void* dmap, int N, int H, int W,
                                 int Hb, int Wb, int oy, int ox, int hy, int hx,
                                 int Hi, int Wi, int dmin, int D, int R, int TH,
                                 float one_m_alpha, float alpha,
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
  switch (TH) {
    case 32: return (int)launch<32>(g1, g2, b, m, N, p, st);
    case 16: return (int)launch<16>(g1, g2, b, m, N, p, st);
    case 8: return (int)launch<8>(g1, g2, b, m, N, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
