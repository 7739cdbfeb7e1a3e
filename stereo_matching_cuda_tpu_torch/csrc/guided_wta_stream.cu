// K1: fused matching cost + guided-filter aggregation + streaming WTA,
// one view, walking rows down a band, on Hopper (sm_90a).
//
// Replaces: stereo_matching_cuda_tpu/ops/pallas_guided.py::_make_stream_kernel
//   (launched by _stream_tiles), K3's function with the strip carry.
// Checked against: stereo_matching_cuda_tpu_torch/ops/fused_guided.py::
//   guided_wta_fused_reference, at the fused fast-path bound.
//
// What it computes: exactly K3's function (guided_wta.cu), with the
// ascending `best >= q` tie rule.  A (N, H, W) batch rides blockIdx.z.
// Like K3 it takes tiles with a global origin (Params in
// guided_common.cuh); the band is picked for the interior.
//
// Design.  The TPU kernel walks each column strip top to bottom and
// carries, per slice, 2R rows of window sums between sequential grid
// steps.  On the H100 the walk is a loop inside the block, as in K5
// (guided_wta_dual_stream.cu): one CTA owns kTW = 64 output columns over
// a band of `band` rows and walks down it STEP rows at a time, keeping
// only the last 2R + STEP rows of each x-sum in shared-memory rings, so
// the 2R y-halo is paid once per band, not once per tile.  Output rows
// lag the input by 2R (a/b lag R behind the cost, q lags R behind a/b).
// The slices are the outer loop and the rows the inner one (one slice's
// rings at a time).  As in K5, what persists across slices stays out of
// shared memory: the band's guide statistics (mean_I, c; their x-sums are
// built in chunks of rows inside the step buffers' space before the walk)
// in a per-CTA device scratch, and the running (best, dmap) in the output
// arrays; both are read back once per slice, from L2.  Each step of the
// walk: (1) cost and I*cost of STEP new rows; (2) their x-sums into ring
// X1; (3) y-sums over X1 -> a, b of STEP rows; (4) their x-sums into ring
// X2; (5) y-sums over X2 -> box(a), box(b) of STEP output rows; (6) q and
// the WTA update.  Passes 2, 4 and 5 sum runs of kRun = 8 windows from
// one direct seed, one plane per task (run_sums1); pass 3 needs both
// planes of a window in one thread and sums kRB = 4 windows directly,
// which gives it twice the tasks of runs.
//
// Block, step, tile and band.  32 x 16 threads at __launch_bounds__(512,
// 2): two CTAs, 32 warps, per SM (at most 64 registers a thread).  The
// walk adds STEP = 16 rows a step, or 8 for radii whose 16-row step
// buffers do not fit one block; the wrapper (ops/_kernels.py) picks the
// step and sizes the band for two CTAs per SM, at most 96 rows.  With the
// guide statistics in L2 the 64-column tile takes a 96-row band at two
// CTAs per SM (in shared memory it stopped at 24 rows): at 6 MP it ran
// 22% faster than 32 columns at band 96, the fastest shape with the
// statistics in shared memory; 8-row steps on 512 threads ran 37-59%
// slower, and pass 3 in runs 4% slower than direct (PERF.md, Findings:
// K2 and K1 redesigned).
//
// What bounds it on the H100.  Shared-memory latency and issue, as K3,
// with the y halo ratio of the cost cut from (TH+4R)/TH to (band+4R)/band
// and that of a/b from (TH+2R)/TH to (band+2R)/band, and the x halo ratio
// of the cost from (32+4R)/32 to (64+4R)/64, for five barriers per step.
// Its shared memory is the step buffers and the band's input windows: at
// R=9, D=16, 16-row steps and band 96, 101,036 bytes, two CTAs per SM.

#include "guided_common.cuh"

namespace {

using namespace guided;

constexpr int kTW = 64;              // output columns per CTA
constexpr int kBY = 16;              // the block is kTileW x kBY threads
constexpr int kNT = kTileW * kBY;    // its threads

struct Geom {
  int P;        // 2R
  int EC, MC;   // cost columns (kTW + 4R) and a/b columns (kTW + 2R)
  int PE, PM;   // their pitches (odd)
  int PQ;       // pitch of the kTW-column planes (odd)
  int I1C, I2C; // guide window width (EC + 2), match window width (EC + D + 1)
  int NR;       // cost rows of the band: band + 4R
  int MB;       // a/b rows of the band: band + 2R
  int RING;     // rows of each x-sum ring: 2R + step
  int walk;     // floats of the per-step buffers
  int CH;       // guide rows per chunk: 2 x (CH + 2R) x PM floats fit `walk`
};

// step: rows one step of the walk adds.
__host__ __device__ inline Geom geometry(int R, int band, int D, int step) {
  Geom g;
  g.P = 2 * R;
  g.EC = kTW + 2 * g.P;
  g.MC = kTW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.PQ = kTW + 1;
  g.I1C = g.EC + 2;
  g.I2C = g.EC + D + 1;
  g.NR = band + 2 * g.P;
  g.MB = band + g.P;
  g.RING = g.P + step;
  g.walk = 2 * step * g.PE + 2 * g.RING * g.PM + 2 * step * g.PM
         + 2 * g.RING * g.PQ + 2 * step * g.PQ;
  g.CH = g.walk / (2 * g.PM) - g.P;   // >= step: the X1 rings alone are 2 x RING x PM
  return g;
}

__host__ inline size_t smem_bytes(int R, int band, int D, int step) {
  const Geom g = geometry(R, band, D, step);
  return (size_t)g.walk * sizeof(float) + (size_t)g.NR * (g.I1C + g.I2C);
}

// Floats of one CTA's guide statistics in the scratch: mean_I and c over
// the band's M rows.
__host__ __device__ inline size_t guide_floats(int R, int band) {
  const Geom g = geometry(R, band, 0, 1);
  return 2 * (size_t)g.MB * g.MC;
}

template <int STEP>
__global__ void __launch_bounds__(kNT, 2)
guided_wta_stream_kernel(const uint8_t* __restrict__ gray1,
                         const uint8_t* __restrict__ gray2,
                         float* __restrict__ best_out,
                         float* __restrict__ dmap_out, float* scratch, Params p, int band) {
  extern __shared__ float smem[];
  const Geom g = geometry(p.R, band, p.D, STEP);
  const int P = g.P, R = p.R, H = p.H, W = p.W, RING = g.RING, PQ = g.PQ;
  const int k = 2 * R + 1;
  float* cost = smem;                        // cost, I*cost: STEP x PE each
  float* x1 = cost + 2 * STEP * g.PE;        // their x-sums: 2 rings of RING x PM
  float* ab = x1 + 2 * RING * g.PM;          // a, b: STEP x PM each
  float* x2 = ab + 2 * STEP * g.PM;          // their x-sums: 2 rings of RING x PQ
  float* qs = x2 + 2 * RING * PQ;            // box(a), box(b): STEP x PQ each
  float* gsum = smem;                        // guide x-sums (2 x (CH + 2R) x PM), before the walk
  uint8_t* i1s = reinterpret_cast<uint8_t*>(smem + g.walk);       // NR x I1C
  uint8_t* i2s = i1s + g.NR * g.I1C;                                // NR x I2C
  // This CTA's guide statistics (mean_I, c: MB x MC each), in device
  // memory: written once, then read from L2 by every slice.
  const size_t cta = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* mean_i = scratch + cta * guide_floats(R, band);
  float* c_i = mean_i + g.MB * g.MC;

  gray1 += (size_t)blockIdx.z * p.Hb * p.Wb;
  gray2 += (size_t)blockIdx.z * p.Hb * p.Wb;
  best_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  dmap_out += (size_t)blockIdx.z * p.Hi * p.Wi;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  // Global coordinates from here on: the tile's interior starts at
  // (iy, ix), and the outputs end at (yend, xend).
  const int x0 = p.ix + blockIdx.x * kTW, y0 = p.iy + blockIdx.y * band;
  const int yend = p.iy + p.Hi, xend = p.ix + p.Wi;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the band's E rows / columns
  const int ym = y0 - R, xm = x0 - R;        // global origin of its M rows / columns

  // Input windows of the whole band, zero outside the image (and the
  // buffer).  i1s column c holds global column xe - 1 + c; i2s column c
  // holds xe + dmin - 1 + c.
  for (int r = threadIdx.y; r < g.NR; r += kBY) {
    const int gy = ye + r;
    for (int c = threadIdx.x; c < g.I1C; c += kTileW)
      i1s[r * g.I1C + c] = buffer_px(gray1, gy, xe - 1 + c, p);
    for (int c = threadIdx.x; c < g.I2C; c += kTileW)
      i2s[r * g.I2C + c] = buffer_px(gray2, gy, xe + p.dmin - 1 + c, p);
  }
  __syncthreads();

  // Guide statistics over the band's M rows, CH rows at a time (as K3:
  // integer x-sums exact in float, y-sums in double, rounded once).
  for (int m0 = 0; m0 < g.MB; m0 += g.CH) {
    const int nm = min(g.CH, g.MB - m0), rows = nm + P;
    float* sa = gsum;
    float* sb = gsum + (g.CH + P) * g.PM;
    {
      const int nblk = (g.MC + kRB - 1) / kRB;
      for (int t = tid; t < rows * nblk; t += kNT) {
        const int r = t % rows, c0 = (t / rows) * kRB;
        const int nv = min(kRB, g.MC - c0);
        const uint8_t* src = i1s + (m0 + r) * g.I1C + 1 + c0;
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
    const int nblk = (nm + kRB - 1) / kRB;
    for (int t = tid; t < g.MC * nblk; t += kNT) {
      const int c = t % g.MC, r0 = (t / g.MC) * kRB;
      const int nv = min(kRB, nm - r0);
      double s1[kRB], s2[kRB];
      window_sums<kRB>(sa + r0 * g.PM + c, g.PM, k, nv, s1);
      window_sums<kRB>(sb + r0 * g.PM + c, g.PM, k, nv, s2);
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (i >= nv) break;
        const int m = m0 + r0 + i, gy = ym + m, gx = xm + c;
        float mv = 0.f, cv = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          guide_stats(s1[i], s2[i], window_area(gy, gx, H, W, R), p.eps, mv, cv);
        mean_i[m * g.MC + c] = mv;
        c_i[m * g.MC + c] = cv;
      }
    }
    __syncthreads();
  }

  const int nsteps = (g.NR + STEP - 1) / STEP;
  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;
    for (int t = 0; t < nsteps; ++t) {
      const int i0 = t * STEP;                // E row of the step's first new row
      const int ns = min(STEP, g.NR - i0);

      // 1. cost and I*cost of the new rows over E (zero outside the
      // image, the out-of-range class where the match column leaves [0, W)).
      for (int e = tid; e < ns * g.EC; e += kNT) {
        const int lr = e / g.EC, c = e % g.EC, r = i0 + lr;
        const int gy = ye + r, gx = xe + c;
        float cv = 0.f, iv = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const uint8_t* q1 = i1s + r * g.I1C + c + 1;   // q1[0] at gx
          iv = (float)q1[0];
          const int gx2 = gx + d;
          cv = (gx2 < 0 || gx2 >= W)
                   ? p.oob
                   : raw_cost(q1, gx, i2s + r * g.I2C + c + s + 1, gx2, p);
        }
        cost[lr * g.PE + c] = cv;
        cost[(STEP + lr) * g.PE + c] = iv * cv;
      }
      __syncthreads();

      // 2. x-sums of both planes into ring X1 (slot = E row % RING), in
      // runs, one plane per task.
      {
        const int nrun = (g.MC + kRun - 1) / kRun;
        for (int e = tid; e < ns * nrun * 2; e += kNT) {
          const int lr = e % ns, rest = e / ns;
          const int c0 = (rest % nrun) * kRun, pl = rest / nrun;
          const float* src = cost + (pl * STEP + lr) * g.PE + c0;
          float* dst = x1 + (pl * RING + (i0 + lr) % RING) * g.PM + c0;
          run_sums1([&](int j) { return src[j]; }, k, min(kRun, g.MC - c0),
                    [&](int i, float sx) { dst[i] = sx; });
        }
      }
      __syncthreads();

      // 3. a/b rows whose windows end in this step's rows: M row m needs
      // E rows m .. m + 2R.  Both planes of a window in one thread, kRB
      // windows down a column at a time.
      const int m_lo = max(0, i0 - P), m_hi = min(g.MB, i0 + ns - P);
      const int nm = m_hi - m_lo;
      if (nm > 0) {
        const float* ra = x1;
        const float* rb = x1 + RING * g.PM;
        auto ab_of = [&](int m, int c, float s1, float s2) {
          const int gy = ym + m, gx = xm + c;
          float a = 0.f, b = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            guided_ab(s1, s2, window_area(gy, gx, H, W, R), mean_i[m * g.MC + c],
                      c_i[m * g.MC + c], a, b);
          ab[(m - m_lo) * g.PM + c] = a;
          ab[(STEP + m - m_lo) * g.PM + c] = b;
        };
        const int nblk = (nm + kRB - 1) / kRB;
        for (int e = tid; e < g.MC * nblk; e += kNT) {
          const int c = e % g.MC, m0 = m_lo + (e / g.MC) * kRB;
          const int nv = min(kRB, m_hi - m0);
          const int slot0 = m0 % RING;
          auto ring = [&](const float* plane, int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * g.PM + c];
          };
          float s1[kRB], s2[kRB];
          window_sums<kRB>([&](int j) { return ring(ra, j); }, k, nv, s1);
          window_sums<kRB>([&](int j) { return ring(rb, j); }, k, nv, s2);
#pragma unroll
          for (int i = 0; i < kRB; ++i)
            if (i < nv) ab_of(m0 + i, c, s1[i], s2[i]);
        }
      }
      __syncthreads();

      // 4. x-sums of a, b over the tile columns into ring X2 (slot = M
      // row % RING), in runs, one plane per task.
      if (nm > 0) {
        constexpr int nrun = kTW / kRun;
        for (int e = tid; e < nm * nrun * 2; e += kNT) {
          const int lr = e % nm, rest = e / nm;
          const int c0 = (rest % nrun) * kRun, pl = rest / nrun;
          const float* src = ab + (pl * STEP + lr) * g.PM + c0;
          float* dst = x2 + (pl * RING + (m_lo + lr) % RING) * PQ + c0;
          run_sums1([&](int j) { return src[j]; }, k, kRun,
                    [&](int i, float sx) { dst[i] = sx; });
        }
      }
      __syncthreads();

      // 5. y-sums over X2 -> box(a), box(b) of the output rows whose
      // windows end in this step's a/b rows: output row o needs M rows
      // o .. o + 2R.  One run per kRun rows down a column, one plane per
      // task.
      const int o_lo = max(0, m_lo - P), o_hi = min(band, m_hi - P);
      const int nq = o_hi - o_lo;
      if (nq > 0) {
        const int nrun = (nq + kRun - 1) / kRun;
        for (int e = tid; e < kTW * nrun * 2; e += kNT) {
          const int c = e % kTW, rest = e / kTW;
          const int o0 = o_lo + (rest % nrun) * kRun, pl = rest / nrun;
          const float* plane = x2 + pl * RING * PQ + c;
          const int slot0 = o0 % RING;
          float* dst = qs + (pl * STEP + o0 - o_lo) * PQ + c;
          run_sums1([&](int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * PQ];
          }, k, min(kRun, o_hi - o0), [&](int i, float sy) { dst[i * PQ] = sy; });
        }
      }
      __syncthreads();

      // 6. q and the WTA update; the running (best, dmap) live in the
      // output arrays (slice 0 starts from best_init()).  No barrier after
      // it: the next step writes cost, X1, ab and X2 first and qs only
      // after four barriers; each output has one owner thread, the same
      // in every slice.
      for (int e = tid; e < nq * kTW; e += kNT) {
        const int lr = e / kTW, c = e % kTW, o = o_lo + lr;
        const int gy = y0 + o, gx = x0 + c;
        if (gy >= yend || gx >= xend) continue;
        const float area = window_area(gy, gx, H, W, R);
        const float iv = (float)i1s[(o + P) * g.I1C + c + P + 1];
        const float q = (qs[lr * PQ + c] / area) * iv + qs[(STEP + lr) * PQ + c] / area;
        const size_t at = (size_t)(gy - p.iy) * p.Wi + (gx - p.ix);
        const float b = s ? best_out[at] : best_init();
        if (b >= q) {
          best_out[at] = q;
          dmap_out[at] = (float)d;
        } else if (s == 0) {
          best_out[at] = b;
          dmap_out[at] = 0.f;
        }
      }
    }
  }
}

template <int STEP>
cudaError_t launch(const uint8_t* gray1, const uint8_t* gray2, float* best,
                   float* dmap, float* scratch, int N, int band, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p.R, band, p.D, STEP);
  cudaError_t err = cudaFuncSetAttribute(
      guided_wta_stream_kernel<STEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Wi + kTW - 1) / kTW, (p.Hi + band - 1) / band, N);
  guided_wta_stream_kernel<STEP><<<grid, dim3(kTileW, kBY), smem, stream>>>(
      gray1, gray2, best, dmap, scratch, p, band);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K1 needs for a radius, a band height, a slice
// count and a step of `step` rows (bytes).  The wrapper picks the step
// and the band with it.
extern "C" long long guided_wta_stream_smem_bytes(int R, int band, int D, int step) {
  return (long long)smem_bytes(R, band, D, step);
}

// Bytes of device scratch one K1 launch needs (the guide statistics of
// every CTA) for N output frames (interiors) of H x W.
extern "C" long long guided_wta_stream_scratch_bytes(int R, int band, int N, int H, int W) {
  const long long ctas = (long long)((W + kTW - 1) / kTW) * ((H + band - 1) / band) * N;
  return ctas * (long long)(guide_floats(R, band) * sizeof(float));
}

// Launches K1 on `stream`.  gray1/gray2: uint8 (N, Hb, Wb) contiguous,
// tiles of an H x W image whose (0, 0) is at global (oy, ox); best/dmap:
// float32 (N, Hi, Wi), the interior at offset (hy, hx) in the tile (see
// Params; a whole frame is Hb = Hi = H, Wb = Wi = W, the rest 0); scratch:
// device memory of guided_wta_stream_scratch_bytes for the interior.
// band (output rows per CTA) >= 1, step 16 or 8.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int guided_wta_stream_launch(const void* gray1, const void* gray2,
                                        void* best, void* dmap, void* scratch, int N, int H,
                                        int W, int Hb, int Wb, int oy, int ox, int hy,
                                        int hx, int Hi, int Wi, int dmin, int D, int R,
                                        int band, int step, float one_m_alpha, float alpha,
                                        float th_color, float th_grad, float oob,
                                        double eps, void* stream) {
  if (band < 1) return (int)cudaErrorInvalidValue;
  Params p = make_params(H, W, dmin, D, R, one_m_alpha, alpha, th_color,
                         th_grad, oob, eps);
  set_tile(p, Hb, Wb, oy, ox, hy, hx, Hi, Wi);
  const auto* g1 = static_cast<const uint8_t*>(gray1);
  const auto* g2 = static_cast<const uint8_t*>(gray2);
  auto* b = static_cast<float*>(best);
  auto* m = static_cast<float*>(dmap);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 16: return (int)launch<16>(g1, g2, b, m, sc, N, band, p, st);
    case 8: return (int)launch<8>(g1, g2, b, m, sc, N, band, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
