// K4: fused matching cost + guided-filter aggregation + WTA for BOTH
// views in one pass, tiled, on Hopper (sm_90a).
//
// Replaces: stereo_matching_cuda_tpu/ops/pallas_guided.py::_make_dual_kernel
//   (launched by guided_wta_fused_dual when the stream flag is off).
// Checked against: stereo_matching_cuda_tpu_torch/ops/fused_guided.py::
//   guided_wta_fused_dual_reference (the two plain single-view calls), per
//   view at the fused fast-path bound (near-tie label flips only).
//
// What it computes: for each view the function of K3 (guided_wta.cu),
// left labels d = dmin .. dmax against the right image, right labels
// -d against the left image, with the tie rules and the shared raw slice
// of guided_common.cuh.  A (B, H, W) batch rides blockIdx.z.
//
// Design.  K3's, with two views.  One CTA owns a 32 x TH output tile and
// recomputes its 2R halo; nothing is carried between CTAs.  It loads
// both uint8 windows once (widened by the column reach of both views),
// computes each view's guide statistics once, then per slice computes
// the raw slice once and runs the two views' guided chains one after the
// other through the same four work planes (K3's buffers).  Each chain is
// K3's: cost and I*cost, then box passes b, c and d in runs of kRun = 8
// windows from one direct seed (run_sums), then pass e, each thread's own
// TH/16 rows summed directly, and the WTA in registers.
//
// Block and tile.  A 16- or 32-row tile runs 32 x 16 = 512 threads at
// __launch_bounds__(512, 2): two CTAs, 32 warps, per SM (at most 64
// registers a thread); an 8-row tile keeps 32 x 8 (block_rows).
//
// What bounds it on the H100.  As K3: shared-memory latency and issue of
// the box passes (4 per view and slice), scaled by the halo ratio
// ((32+4R)(TH+4R)/(32 TH) for the cost: 4.5 at TH=32, 6.9 at TH=16),
// against 2 bytes of input per pixel; the raw slice saves one of the two
// cost evaluations per pixel and slice.  Shared memory decides how many
// CTAs share an SM: with both views' mean_I and c in shared memory a
// TH=32 CTA took ~139 KB (one CTA per SM) and ran slower than TH=16 at
// two.  So the guide statistics (written once per CTA, read once per
// slice) live in a per-CTA device scratch that stays in L2, and a CTA at
// R=9, D=16 takes 99,416 bytes at TH=32: two CTAs per SM (PERF.md,
// Findings: the port and what it taught).

#include "guided_common.cuh"

namespace {

using namespace guided;

// Geometry of one CTA's shared-memory windows.  Pitches are odd.
struct Geom {
  int P;        // 2R
  int ER, EC;   // cost region E: tile + 2R on each side
  int MR, MC;   // a/b region M: tile + R on each side
  int PE, PM;   // pitches of the E planes and of the M-wide planes
  int WC;       // input window width: EC + 2 + reach
  int PR;       // pitch of the raw slice (>= EC + reach)
};

__host__ __device__ inline Geom geometry(int R, int TH, int reach) {
  Geom g;
  g.P = 2 * R;
  g.ER = TH + 2 * g.P;
  g.EC = kTileW + 2 * g.P;
  g.MR = TH + g.P;
  g.MC = kTileW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.WC = g.EC + 2 + reach;
  g.PR = (g.EC + reach) | 1;
  return g;
}

__host__ inline size_t smem_bytes(int R, int TH, int reach) {
  const Geom g = geometry(R, TH, reach);
  const size_t floats = 2 * (size_t)g.ER * g.PE    // cost, I*cost; then a, b
                      + 2 * (size_t)g.ER * g.PM    // their x-sums
                      + (size_t)g.ER * g.PR;       // the raw slice
  return floats * sizeof(float) + 2 * (size_t)g.ER * g.WC;
}

// Floats of one CTA's guide statistics in the scratch: mean_I, c of each
// view over M.
__host__ __device__ inline size_t guide_floats(int R, int TH) {
  const Geom g = geometry(R, TH, 0);
  return 4 * (size_t)g.MR * g.MC;
}

template <int TH, int BY>
__global__ void __launch_bounds__(kTileW * BY, 2)
guided_wta_dual_kernel(const uint8_t* __restrict__ gray_l,
                       const uint8_t* __restrict__ gray_r,
                       float* __restrict__ best_l_out, float* __restrict__ dmap_l_out,
                       float* __restrict__ best_r_out, float* __restrict__ dmap_r_out,
                       float* scratch, Params p) {
  constexpr int NT = kTileW * BY;       // threads of the block
  constexpr int kRows = TH / BY;        // output rows per thread
  extern __shared__ float smem[];
  const Geom g = geometry(p.R, TH, p.pos + p.neg);
  const int P = g.P, R = p.R, H = p.H, W = p.W;
  const int k = 2 * R + 1;
  float* buf1a = smem;                       // cost      -> a
  float* buf1b = buf1a + g.ER * g.PE;        // I*cost    -> b
  float* buf2a = buf1b + g.ER * g.PE;        // xsum(cost)   -> xsum(a)
  float* buf2b = buf2a + g.ER * g.PM;        // xsum(I*cost) -> xsum(b)
  float* raw = buf2b + g.ER * g.PM;          // ER x PR
  uint8_t* win = reinterpret_cast<uint8_t*>(raw + g.ER * g.PR);   // left, right: ER x WC

  // This CTA's guide statistics (mean_l, c_l, mean_r, c_r: MR x MC), in
  // device memory: written once, then read from L2 by every slice.
  const size_t cta = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* guide = scratch + cta * guide_floats(R, TH);
  const size_t frame = (size_t)blockIdx.z * H * W;
  gray_l += frame;
  gray_r += frame;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * TH;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the E region
  const int ym = y0 - R, xm = x0 - R;        // global origin of the M region
  const int off[2] = {p.pos, p.neg};         // window column of E column c: c + 1 + off

  // Input windows, zero outside the image.
  for (int r = ty; r < g.ER; r += BY) {
    const int gy = ye + r;
    const bool row_in = gy >= 0 && gy < H;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint8_t* src = v ? gray_r : gray_l;
      uint8_t* dst = win + v * g.ER * g.WC + r * g.WC;
      for (int c = tx; c < g.WC; c += kTileW) {
        const int gx = xe - 1 - off[v] + c;
        dst[c] = (row_in && gx >= 0 && gx < W) ? src[(size_t)gy * W + gx] : 0;
      }
    }
  }
  __syncthreads();

  // Guide statistics of each view over M: integer x-sums (exact in
  // float), y-sums in double, rounded once (see guide_stats).
  for (int v = 0; v < 2; ++v) {
    const uint8_t* iw = win + v * g.ER * g.WC + 1 + off[v];
    x_sums<float, NT>([&](int r, int c) { return (float)iw[r * g.WC + c]; },
                  [&](int r, int c) { const float x = iw[r * g.WC + c]; return x * x; },
                  buf2a, buf2b, g.PM, g.ER, g.MC, k, tid);
    __syncthreads();
    float* mean_v = guide + (2 * v) * g.MR * g.MC;
    float* c_v = mean_v + g.MR * g.MC;
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
        mean_v[(r0 + i) * g.MC + c] = m;
        c_v[(r0 + i) * g.MC + c] = cc;
      }
    }
    __syncthreads();
  }

  float best[2][kRows], dmap[2][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    best[0][i] = best[1][i] = best_init();
    dmap[0][i] = dmap[1][i] = 0.f;
  }
  const int yq = ty * kRows;                 // this thread's first output row

  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;

    // 1. The raw slice over E rows and both views' columns: raw column j
    // (global xe - pos + j) pairs left window column j + 1 with right
    // window column j + 1 + d + neg - pos.
    {
      const int jlo = p.pos + min(0, -d);
      const int n = g.EC + abs(d);
      const uint8_t* wl = win;
      const uint8_t* wr = win + g.ER * g.WC;
      for (int r = ty; r < g.ER; r += BY)
        for (int c = tx; c < n; c += kTileW) {
          const int j = jlo + c, gx = xe - p.pos + j;
          raw[r * g.PR + j] = raw_cost(wl + r * g.WC + j + 1, gx,
                                       wr + r * g.WC + j + 1 + d + p.neg - p.pos,
                                       gx + d, p);
        }
    }
    __syncthreads();

#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int dm = v ? -d : d;               // the view's match offset and label
      const uint8_t* iw = win + v * g.ER * g.WC + 1 + off[v];
      const int rshift = p.pos - (v ? d : 0);  // raw column of E column c: c + rshift
      float* mean_v = guide + (2 * v) * g.MR * g.MC;
      float* c_v = mean_v + g.MR * g.MC;

      // a. The view's cost and I*cost over E (zero outside the image,
      // the out-of-range class where its match column leaves [0, W)).
      for (int r = ty; r < g.ER; r += BY) {
        const int gy = ye + r;
        for (int c = tx; c < g.EC; c += kTileW) {
          const int gx = xe + c;
          float cost = 0.f, iv = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            iv = (float)iw[r * g.WC + c];
            const int gx2 = gx + dm;
            cost = (gx2 < 0 || gx2 >= W) ? p.oob : raw[r * g.PR + c + rshift];
          }
          buf1a[r * g.PE + c] = cost;
          buf1b[r * g.PE + c] = iv * cost;
        }
      }
      __syncthreads();

      // b. x-window sums over (E rows) x (M columns), in runs.
      x_runs<NT>(buf1a, buf1b, g.PE, buf2a, buf2b, g.PM, g.ER, g.MC, k, tid);
      __syncthreads();

      // c. y-window sums in runs down a column -> a, b over M (into buf1).
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
                  guided_ab(s1, s2, window_area(gy, gx, H, W, R), mean_v[r * g.MC + c],
                            c_v[r * g.MC + c], a, b);
                buf1a[r * g.PM + c] = a;
                buf1b[r * g.PM + c] = b;
              });
        }
      }
      __syncthreads();

      // d. x-window sums of a, b over (M rows) x (tile columns), in runs.
      x_runs<NT>(buf1a, buf1b, g.PM, buf2a, buf2b, kTileW + 1, g.MR, kTileW, k, tid);
      __syncthreads();

      // e. y-window sums -> q -> WTA in registers.  The next chain's (or
      // slice's) first step writes buf1 or the raw slice only; buf2 is
      // written again only after the barrier that ends it.
      {
        float sa[kRows], sb[kRows];
        window_sums<kRows>(buf2a + yq * (kTileW + 1) + tx, kTileW + 1, k, kRows, sa);
        window_sums<kRows>(buf2b + yq * (kTileW + 1) + tx, kTileW + 1, k, kRows, sb);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int gy = y0 + yq + i, gx = x0 + tx;
          if (gy < H && gx < W) {
            const float area = window_area(gy, gx, H, W, R);
            const float iv = (float)iw[(yq + i + P) * g.WC + tx + P];
            const float q = (sa[i] / area) * iv + sb[i] / area;
            if (v == 0 ? best[0][i] >= q : best[1][i] > q) {
              best[v][i] = q;
              dmap[v][i] = (float)dm;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gy = y0 + yq + i, gx = x0 + tx;
    if (gy < H && gx < W) {
      const size_t o = frame + (size_t)gy * W + gx;
      best_l_out[o] = best[0][i];
      dmap_l_out[o] = dmap[0][i];
      best_r_out[o] = best[1][i];
      dmap_r_out[o] = dmap[1][i];
    }
  }
}

template <int TH>
cudaError_t launch(const uint8_t* gl, const uint8_t* gr, float* const* outs,
                   float* scratch, int N, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.R, TH, p.pos + p.neg);
  constexpr int BY = block_rows(TH);
  cudaError_t err = cudaFuncSetAttribute(
      guided_wta_dual_kernel<TH, BY>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + TH - 1) / TH, N);
  guided_wta_dual_kernel<TH, BY><<<grid, dim3(kTileW, BY), smem, stream>>>(
      gl, gr, outs[0], outs[1], outs[2], outs[3], scratch, p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K4 needs for a radius, a tile height and the
// column reach max(0, d_max) + max(0, -d_min) (bytes).
extern "C" long long guided_wta_dual_smem_bytes(int R, int TH, int reach) {
  return (long long)smem_bytes(R, TH, reach);
}

// Bytes of device scratch one K4 launch needs (the guide statistics of
// every CTA) for N frames of H x W.
extern "C" long long guided_wta_dual_scratch_bytes(int R, int TH, int N, int H, int W) {
  const long long ctas = (long long)((W + kTileW - 1) / kTileW) * ((H + TH - 1) / TH) * N;
  return ctas * (long long)(guide_floats(R, TH) * sizeof(float));
}

// Launches K4 on `stream`.  gray_l/gray_r: uint8 (N, H, W) contiguous;
// best_l, dmap_l, best_r, dmap_r: float32 (N, H, W); scratch: device
// memory of guided_wta_dual_scratch_bytes.  Left labels are dmin .. dmin
// + D - 1, right labels their negatives.  TH must be 8, 16 or 32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int guided_wta_dual_launch(const void* gray_l, const void* gray_r,
                                      void* best_l, void* dmap_l,
                                      void* best_r, void* dmap_r, void* scratch,
                                      int N, int H, int W, int dmin, int D, int R,
                                      int TH, float one_m_alpha, float alpha,
                                      float th_color, float th_grad, float oob,
                                      double eps, void* stream) {
  const Params p = make_params(H, W, dmin, D, R, one_m_alpha, alpha, th_color,
                               th_grad, oob, eps);
  const auto* gl = static_cast<const uint8_t*>(gray_l);
  const auto* gr = static_cast<const uint8_t*>(gray_r);
  float* outs[4] = {static_cast<float*>(best_l), static_cast<float*>(dmap_l),
                    static_cast<float*>(best_r), static_cast<float*>(dmap_r)};
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (TH) {
    case 32: return (int)launch<32>(gl, gr, outs, sc, N, p, st);
    case 16: return (int)launch<16>(gl, gr, outs, sc, N, p, st);
    case 8: return (int)launch<8>(gl, gr, outs, sc, N, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
