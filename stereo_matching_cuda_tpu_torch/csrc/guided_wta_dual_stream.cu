// K5: fused matching cost + guided-filter aggregation + WTA for BOTH
// views in one pass, walking rows down a band, on Hopper (sm_90a).
//
// Replaces: stereo_matching_cuda_tpu/ops/pallas_guided.py::
//   _make_dual_stream_kernel (launched by _dual_stream), K4's function
//   with the strip carry.
// Checked against: stereo_matching_cuda_tpu_torch/ops/fused_guided.py::
//   guided_wta_fused_dual_reference, per view at the fused fast-path bound.
//
// What it computes: exactly K4's function (guided_wta_dual.cu), with the
// shared raw slice and tie rules of guided_common.cuh.  A (B, H, W) batch
// rides blockIdx.z.
//
// Design.  The TPU kernel walks each column strip top to bottom and
// carries, per slice, 8 planes of 2R rows (cost and I*cost x-sums, a and
// b x-sums, both views) between sequential grid steps.  On the H100 the
// walk is a loop inside the block: one CTA owns 32 output columns over a
// band of `band` rows and walks down it STEP rows at a time, keeping only
// the last 2R + STEP rows of each x-sum in shared-memory rings, so the
// 2R y-halo is paid once per band, not once per tile.  Output rows lag
// the input by 2R (a/b lag R behind the cost, q lags R behind a/b).
//
// Carrying every slice at once does not fit a block: at R=9 one slice's
// rings take ~24 KB, ~378 KB at D=16.  So the slices are the OUTER loop
// and the rows the inner one: one slice's rings at a time.  What persists
// across slices stays out of shared memory: both views' guide statistics
// over the band (computed once) in a per-CTA device scratch, and the
// running (best, dmap) of both views in the output arrays themselves;
// both are read back once per slice, from L2.  Each step of the walk:
// (1) the raw slice of STEP new rows; (2) each view's masked cost and
// I*cost; (3) their x-sums into ring X1; (4) y-sums over X1 -> a, b of
// STEP rows; (5) their x-sums into ring X2; (6) y-sums over X2 ->
// box(a), box(b) of STEP output rows; (7) q and the WTA update.  Passes
// 3-6 sum runs of kRun = 8 windows from one direct seed (run_sums): a
// step's new windows down a column are one run per 8 rows (2R + 8 loads
// where two direct blocks of 4 took 2(2R + 4)), and along x the runs
// slide as in K3.  Passes 3, 5 and 6 take one plane per thread, pass 4
// the two planes that make a and b.
//
// Block and step.  32 x 16 threads at __launch_bounds__(512, 2): two
// CTAs, 32 warps, per SM (at most 64 registers a thread).  The walk adds
// STEP = 16 rows a step, or 8 for radii whose 16-row step buffers do not
// fit one block; the wrapper (ops/_kernels.py) picks the step and sizes
// the band for two CTAs per SM, at most 96 rows.  With 16-row steps a
// step's passes have 200-512 tasks for 512 threads and half the barriers
// per output row: 20% faster at 6 MP than the first design's 32 x 8
// threads with 8-row steps at three CTAs per SM.  On that first shape
// runs of 8 left half the block idle in passes 4-6 and ran 4% slower
// than direct sums; on this one they beat direct sums of 4 by 4%
// (PERF.md, Findings: K3, K4 and K5 redesigned).
//
// What bounds it on the H100.  Shared-memory latency and issue, as K4,
// with the y halo ratio of the cost cut from (TH+4R)/TH to
// (band+4R)/band and that of a/b from (TH+2R)/TH to (band+2R)/band, for
// seven barriers per step.  Its shared memory is the step buffers and
// the band's input windows: at R=9, D=16, 16-row steps, 112,616 bytes at
// band 96, two CTAs per SM.  Keeping the band-sized planes in shared
// memory instead capped the band at 24 rows for two CTAs per SM and
// measured 1.5x slower (PERF.md, Findings: the port and what it taught).

#include "guided_common.cuh"

namespace {

using namespace guided;

constexpr int kPQ = kTileW + 1;      // pitch of the 32-column planes
constexpr int kBY = 16;              // the block is kTileW x kBY threads

struct Geom {
  int P;        // 2R
  int EC, MC;   // cost columns (32 + 4R) and a/b columns (32 + 2R)
  int PE, PM;   // their pitches (odd)
  int WC;       // input window width: EC + 2 + reach
  int PR;       // pitch of the raw slice (>= EC + reach)
  int NR;       // cost rows of the band: band + 4R
  int MB;       // a/b rows of the band: band + 2R
  int RING;     // rows of each x-sum ring: 2R + step
  int walk;     // floats of the per-step buffers
};

// step: rows one step of the walk adds.
__host__ __device__ inline Geom geometry(int R, int band, int reach, int step) {
  Geom g;
  g.P = 2 * R;
  g.EC = kTileW + 2 * g.P;
  g.MC = kTileW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.WC = g.EC + 2 + reach;
  g.PR = (g.EC + reach) | 1;
  g.NR = band + 2 * g.P;
  g.MB = band + g.P;
  g.RING = g.P + step;
  const int walk = step * g.PR + 4 * step * g.PE + 4 * g.RING * g.PM
                 + 4 * step * g.PM + 4 * g.RING * kPQ + 4 * step * kPQ;
  const int guide_tmp = 2 * g.NR * g.PM;     // guide x-sums, before the walk
  g.walk = walk > guide_tmp ? walk : guide_tmp;
  return g;
}

__host__ inline size_t smem_bytes(int R, int band, int reach, int step) {
  const Geom g = geometry(R, band, reach, step);
  return (size_t)g.walk * sizeof(float) + 2 * (size_t)g.NR * g.WC;
}

// Floats of one CTA's guide statistics in the scratch: mean_I, c of each
// view over the band's M rows.
__host__ __device__ inline size_t guide_floats(int R, int band) {
  const Geom g = geometry(R, band, 0, 1);
  return 4 * (size_t)g.MB * g.MC;
}

template <int STEP>
__global__ void __launch_bounds__(kTileW * kBY, 2)
guided_wta_dual_stream_kernel(const uint8_t* __restrict__ gray_l,
                              const uint8_t* __restrict__ gray_r,
                              float* __restrict__ best_l_out, float* __restrict__ dmap_l_out,
                              float* __restrict__ best_r_out, float* __restrict__ dmap_r_out,
                              float* scratch, Params p, int band) {
  constexpr int NT = kTileW * kBY;      // threads of the block
  extern __shared__ float smem[];
  const Geom g = geometry(p.R, band, p.pos + p.neg, STEP);
  const int P = g.P, R = p.R, H = p.H, W = p.W, RING = g.RING;
  const int k = 2 * R + 1;
  // This CTA's guide statistics (mean_l, c_l, mean_r, c_r: MB x MC), in
  // device memory: written once, then read from L2 by every slice.
  const size_t cta = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* guide = scratch + cta * guide_floats(R, band);
  float* work = smem;
  float* raw = work;                          // STEP x PR
  float* cost = raw + STEP * g.PR;            // cost_l, I*cost_l, cost_r, I*cost_r: STEP x PE
  float* x1 = cost + 4 * STEP * g.PE;         // their x-sums: 4 rings of RING x PM
  float* ab = x1 + 4 * RING * g.PM;           // a_l, b_l, a_r, b_r: STEP x PM
  float* x2 = ab + 4 * STEP * g.PM;           // their x-sums: 4 rings of RING x kPQ
  float* qs = x2 + 4 * RING * kPQ;            // box(a), box(b) of each view: STEP x kPQ
  float* gsum = work;                         // guide x-sums (2 x NR x PM), before the walk
  uint8_t* win = reinterpret_cast<uint8_t*>(work + g.walk);   // left, right: NR x WC

  const size_t frame = (size_t)blockIdx.z * H * W;
  gray_l += frame;
  gray_r += frame;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * band;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the band's E rows / columns
  const int ym = y0 - R, xm = x0 - R;        // global origin of its M rows / columns
  const int off[2] = {p.pos, p.neg};         // window column of E column c: c + 1 + off

  // Input windows of the whole band, zero outside the image.
  for (int r = threadIdx.y; r < g.NR; r += kBY) {
    const int gy = ye + r;
    const bool row_in = gy >= 0 && gy < H;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint8_t* src = v ? gray_r : gray_l;
      uint8_t* dst = win + v * g.NR * g.WC + r * g.WC;
      for (int c = threadIdx.x; c < g.WC; c += kTileW) {
        const int gx = xe - 1 - off[v] + c;
        dst[c] = (row_in && gx >= 0 && gx < W) ? src[(size_t)gy * W + gx] : 0;
      }
    }
  }
  __syncthreads();

  // Guide statistics of each view over the band's M rows (as K3 and K4:
  // integer x-sums exact in float, y-sums in double, rounded once).
  for (int v = 0; v < 2; ++v) {
    const uint8_t* iw = win + v * g.NR * g.WC + 1 + off[v];
    float* sa = gsum;
    float* sb = gsum + g.NR * g.PM;
    {
      const int nblk = (g.MC + kRB - 1) / kRB;
      for (int t = tid; t < g.NR * nblk; t += NT) {
        const int r = t % g.NR, c0 = (t / g.NR) * kRB;
        const int nv = min(kRB, g.MC - c0);
        const uint8_t* src = iw + r * g.WC + c0;
        float s1[kRB], s2[kRB];
        window_sums<kRB>([&](int j) { return (float)src[j]; }, k, nv, s1);
        window_sums<kRB>([&](int j) { const float x = src[j]; return x * x; }, k, nv, s2);
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          if (i < nv) {
            sa[r * g.PM + c0 + i] = s1[i];
            sb[r * g.PM + c0 + i] = s2[i];
          }
      }
    }
    __syncthreads();
    float* mean_v = guide + (2 * v) * g.MB * g.MC;
    float* c_v = mean_v + g.MB * g.MC;
    const int nblk = (g.MB + kRB - 1) / kRB;
    for (int t = tid; t < g.MC * nblk; t += NT) {
      const int c = t % g.MC, r0 = (t / g.MC) * kRB;
      const int nv = min(kRB, g.MB - r0);
      double s1[kRB], s2[kRB];
      window_sums<kRB>([&](int j) { return sa[(r0 + j) * g.PM + c]; }, k, nv, s1);
      window_sums<kRB>([&](int j) { return sb[(r0 + j) * g.PM + c]; }, k, nv, s2);
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

  const uint8_t* wl = win;
  const uint8_t* wr = win + g.NR * g.WC;
  const int nsteps = (g.NR + STEP - 1) / STEP;
  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;
    const int jlo = p.pos + min(0, -d);     // raw columns of this slice: jlo .. jlo + nraw - 1
    const int nraw = g.EC + abs(d);

    for (int t = 0; t < nsteps; ++t) {
      const int i0 = t * STEP;                // E row of the step's first new row
      const int ns = min(STEP, g.NR - i0);

      // 1. The raw slice of the new rows (columns as in K4).
      for (int e = tid; e < ns * nraw; e += NT) {
        const int lr = e / nraw, j = jlo + e % nraw, i = i0 + lr;
        const int gx = xe - p.pos + j;
        raw[lr * g.PR + j] = raw_cost(wl + i * g.WC + j + 1, gx,
                                      wr + i * g.WC + j + 1 + d + p.neg - p.pos,
                                      gx + d, p);
      }
      __syncthreads();

      // 2. Each view's cost and I*cost over E (zero outside the image,
      // the out-of-range class where its match column leaves [0, W)).
      for (int e = tid; e < ns * g.EC; e += NT) {
        const int lr = e / g.EC, c = e % g.EC, i = i0 + lr;
        const int gy = ye + i, gx = xe + c;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float cv = 0.f, iv = 0.f;
          if (in) {
            const uint8_t* iw = v ? wr : wl;
            iv = (float)iw[i * g.WC + c + 1 + off[v]];
            const int gx2 = v ? gx - d : gx + d;
            cv = (gx2 < 0 || gx2 >= W) ? p.oob
                                       : raw[lr * g.PR + c + p.pos - (v ? d : 0)];
          }
          cost[(2 * v) * STEP * g.PE + lr * g.PE + c] = cv;
          cost[(2 * v + 1) * STEP * g.PE + lr * g.PE + c] = iv * cv;
        }
      }
      __syncthreads();

      // 3. x-sums of the four planes into ring X1 (slot = E row % RING),
      // in runs, one plane per task.
      {
        const int nrun = (g.MC + kRun - 1) / kRun;
        for (int e = tid; e < ns * nrun * 4; e += NT) {
          const int lr = e % ns, rest = e / ns;
          const int c0 = (rest % nrun) * kRun, pl = rest / nrun;
          const float* src = cost + pl * STEP * g.PE + lr * g.PE + c0;
          float* dst = x1 + pl * RING * g.PM + ((i0 + lr) % RING) * g.PM + c0;
          run_sums1([&](int j) { return src[j]; }, k, min(kRun, g.MC - c0),
                    [&](int i, float sx) { dst[i] = sx; });
        }
      }
      __syncthreads();

      // 4. a/b rows whose windows end in this step's rows: M row m needs
      // E rows m .. m + 2R.  One run per 8 rows down a column.
      const int m_lo = max(0, i0 - P), m_hi = min(g.MB, i0 + ns - P);
      const int nm = m_hi - m_lo;
      if (nm > 0) {
        const int nrun = (nm + kRun - 1) / kRun;
        for (int e = tid; e < g.MC * nrun * 2; e += NT) {
          const int c = e % g.MC, rest = e / g.MC;
          const int m0 = m_lo + (rest % nrun) * kRun, v = rest / nrun;
          const float* ra = x1 + (2 * v) * RING * g.PM + c;
          const float* rb = ra + RING * g.PM;
          const int slot0 = m0 % RING;
          auto ring = [&](const float* plane, int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * g.PM];
          };
          const float* mean_v = guide + (2 * v) * g.MB * g.MC;
          const float* c_v = mean_v + g.MB * g.MC;
          float* da = ab + (2 * v) * STEP * g.PM + (m0 - m_lo) * g.PM + c;
          float* db = da + STEP * g.PM;
          run_sums<kRun>(
              [&](int j) { return ring(ra, j); }, [&](int j) { return ring(rb, j); }, k,
              min(kRun, m_hi - m0), [&](int i, float s1, float s2) {
                const int m = m0 + i, gy = ym + m, gx = xm + c;
                float a = 0.f, b = 0.f;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  guided_ab(s1, s2, window_area(gy, gx, H, W, R), mean_v[m * g.MC + c],
                            c_v[m * g.MC + c], a, b);
                da[i * g.PM] = a;
                db[i * g.PM] = b;
              });
        }
      }
      __syncthreads();

      // 5. x-sums of a, b over the tile columns into ring X2 (slot = M
      // row % RING), in runs, one plane per task.
      if (nm > 0) {
        constexpr int nrun = kTileW / kRun;
        for (int e = tid; e < nm * nrun * 4; e += NT) {
          const int lr = e % nm, rest = e / nm;
          const int c0 = (rest % nrun) * kRun, pl = rest / nrun;
          const float* src = ab + pl * STEP * g.PM + lr * g.PM + c0;
          float* dst = x2 + pl * RING * kPQ + ((m_lo + lr) % RING) * kPQ + c0;
          run_sums1([&](int j) { return src[j]; }, k, kRun,
                    [&](int i, float sx) { dst[i] = sx; });
        }
      }
      __syncthreads();

      // 6. y-sums over X2 -> box(a), box(b) of the output rows whose
      // windows end in this step's a/b rows: output row o needs M rows
      // o .. o + 2R.  One run per 8 rows down a column, one plane per task.
      const int o_lo = max(0, m_lo - P), o_hi = min(band, m_hi - P);
      const int nq = o_hi - o_lo;
      if (nq > 0) {
        const int nrun = (nq + kRun - 1) / kRun;
        for (int e = tid; e < kTileW * nrun * 4; e += NT) {
          const int c = e % kTileW, rest = e / kTileW;
          const int o0 = o_lo + (rest % nrun) * kRun, pl = rest / nrun;
          const float* plane = x2 + pl * RING * kPQ + c;
          const int slot0 = o0 % RING;
          float* dst = qs + pl * STEP * kPQ + (o0 - o_lo) * kPQ + c;
          run_sums1([&](int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * kPQ];
          }, k, min(kRun, o_hi - o0), [&](int i, float sy) { dst[i * kPQ] = sy; });
        }
      }
      __syncthreads();

      // 7. q and the WTA update of both views, whose running (best, dmap)
      // live in the output arrays (slice 0 starts from best_init()).  No
      // barrier after it: the next step writes raw, cost, X1, ab and X2
      // first and qs only after four barriers; each output has one owner
      // thread, the same in every slice.
      for (int e = tid; e < nq * kTileW; e += NT) {
        const int lr = e / kTileW, c = e % kTileW, o = o_lo + lr;
        const int gy = y0 + o, gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const float area = window_area(gy, gx, H, W, R);
        const int wo = (o + P) * g.WC + c + P + 1;
        const size_t q = frame + (size_t)gy * W + gx;
        const float il = (float)wl[wo + p.pos];
        const float ql = (qs[lr * kPQ + c] / area) * il
                       + qs[STEP * kPQ + lr * kPQ + c] / area;
        const float bl = s ? best_l_out[q] : best_init();
        if (bl >= ql) {
          best_l_out[q] = ql;
          dmap_l_out[q] = (float)d;
        } else if (s == 0) {
          best_l_out[q] = bl;
          dmap_l_out[q] = 0.f;
        }
        const float ir = (float)wr[wo + p.neg];
        const float qr = (qs[2 * STEP * kPQ + lr * kPQ + c] / area) * ir
                       + qs[3 * STEP * kPQ + lr * kPQ + c] / area;
        const float br = s ? best_r_out[q] : best_init();
        if (br > qr) {
          best_r_out[q] = qr;
          dmap_r_out[q] = (float)-d;
        } else if (s == 0) {
          best_r_out[q] = br;
          dmap_r_out[q] = 0.f;
        }
      }
    }
  }
}

template <int STEP>
cudaError_t launch(const uint8_t* gl, const uint8_t* gr, float* const* outs,
                   float* scratch, int N, const Params& p, int band, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.R, band, p.pos + p.neg, STEP);
  cudaError_t err = cudaFuncSetAttribute(guided_wta_dual_stream_kernel<STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + band - 1) / band, N);
  guided_wta_dual_stream_kernel<STEP><<<grid, dim3(kTileW, kBY), smem, stream>>>(
      gl, gr, outs[0], outs[1], outs[2], outs[3], scratch, p, band);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K5 needs for a radius, a band height, the column
// reach max(0, d_max) + max(0, -d_min) and a step of `step` rows (bytes).
extern "C" long long guided_wta_dual_stream_smem_bytes(int R, int band, int reach,
                                                       int step) {
  return (long long)smem_bytes(R, band, reach, step);
}

// Bytes of device scratch one K5 launch needs (the guide statistics of
// every CTA) for N frames of H x W.
extern "C" long long guided_wta_dual_stream_scratch_bytes(int R, int band, int N,
                                                          int H, int W) {
  const long long ctas = (long long)((W + kTileW - 1) / kTileW) * ((H + band - 1) / band) * N;
  return ctas * (long long)(guide_floats(R, band) * sizeof(float));
}

// Launches K5 on `stream`.  Arguments as guided_wta_dual_launch, with the
// band height (output rows per CTA, >= 1) in place of the tile height
// and the step (8 or 16 rows), and `scratch`: device memory of
// guided_wta_dual_stream_scratch_bytes.
extern "C" int guided_wta_dual_stream_launch(const void* gray_l, const void* gray_r,
                                             void* best_l, void* dmap_l,
                                             void* best_r, void* dmap_r,
                                             void* scratch,
                                             int N, int H, int W, int dmin, int D,
                                             int R, int band, int step,
                                             float one_m_alpha, float alpha,
                                             float th_color, float th_grad, float oob,
                                             double eps, void* stream) {
  if (band < 1) return (int)cudaErrorInvalidValue;
  const Params p = make_params(H, W, dmin, D, R, one_m_alpha, alpha, th_color,
                               th_grad, oob, eps);
  const auto* gl = static_cast<const uint8_t*>(gray_l);
  const auto* gr = static_cast<const uint8_t*>(gray_r);
  float* outs[4] = {static_cast<float*>(best_l), static_cast<float*>(dmap_l),
                    static_cast<float*>(best_r), static_cast<float*>(dmap_r)};
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 16: return (int)launch<16>(gl, gr, outs, sc, N, p, band, st);
    case 8: return (int)launch<8>(gl, gr, outs, sc, N, p, band, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
