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
//
// Design.  The TPU kernel walks each column strip top to bottom and
// carries, per slice, 2R rows of window sums between sequential grid
// steps.  On the H100 the walk is a loop inside the block, as in K5
// (guided_wta_dual_stream.cu): one CTA owns TW output columns over a band
// of `band` rows and walks down it kStep rows at a time, keeping only the
// last 2R + kStep rows of each x-sum in shared-memory rings, so the 2R
// y-halo is paid once per band, not once per tile.  Output rows lag the
// input by 2R (a/b lag R behind the cost, q lags R behind a/b).  The
// slices are the outer loop and the rows the inner one (one slice's rings
// at a time).  One view needs half of K5's step buffers, so the band's
// guide statistics (mean_I, c) stay in shared memory; their x-sums are
// built in chunks of rows inside the step buffers' space before the walk.
// The running (best, dmap) live in the output arrays, read back once per
// slice from L2.  Each step of the walk: (1) cost and I*cost of kStep new
// rows; (2) their x-sums into ring X1; (3) y-sums over X1 -> a, b of
// kStep rows; (4) their x-sums into ring X2; (5) y-sums over X2 ->
// box(a), box(b) of kStep output rows; (6) q and the WTA update.  Every
// window is summed directly (kRB windows at once).
//
// What bounds it on the H100.  Shared-memory traffic and instruction
// throughput, as K3, with the y halo ratio of the cost cut from
// (TH+4R)/TH to (band+4R)/band and that of a/b from (TH+2R)/TH to
// (band+2R)/band, for five barriers per step of kStep rows.  A 64-column
// tile (TW) cuts the x halo ratio of the cost from (32+4R)/32 to
// (64+4R)/64.

#include "guided_common.cuh"

namespace {

using namespace guided;

constexpr int kStep = 8;             // rows one step of the walk adds

struct Geom {
  int P;        // 2R
  int EC, MC;   // cost columns (TW + 4R) and a/b columns (TW + 2R)
  int PE, PM;   // their pitches (odd)
  int PQ;       // pitch of the TW-column planes (odd)
  int I1C, I2C; // guide window width (EC + 2), match window width (EC + D + 1)
  int NR;       // cost rows of the band: band + 4R
  int MB;       // a/b rows of the band: band + 2R
  int RING;     // rows of each x-sum ring: 2R + kStep
  int walk;     // floats of the per-step buffers
  int CH;       // guide rows per chunk: 2 x (CH + 2R) x PM floats fit `walk`
};

__host__ __device__ inline Geom geometry(int TW, int R, int band, int D) {
  Geom g;
  g.P = 2 * R;
  g.EC = TW + 2 * g.P;
  g.MC = TW + g.P;
  g.PE = g.EC | 1;
  g.PM = g.MC | 1;
  g.PQ = TW + 1;
  g.I1C = g.EC + 2;
  g.I2C = g.EC + D + 1;
  g.NR = band + 2 * g.P;
  g.MB = band + g.P;
  g.RING = g.P + kStep;
  g.walk = 2 * kStep * g.PE + 2 * g.RING * g.PM + 2 * kStep * g.PM
         + 2 * g.RING * g.PQ + 2 * kStep * g.PQ;
  g.CH = g.walk / (2 * g.PM) - g.P;   // >= kStep: the X1 rings alone are 2 x RING x PM
  return g;
}

__host__ inline size_t smem_bytes(int TW, int R, int band, int D) {
  const Geom g = geometry(TW, R, band, D);
  return ((size_t)g.walk + 2 * (size_t)g.MB * g.MC) * sizeof(float)
         + (size_t)g.NR * (g.I1C + g.I2C);
}

template <int TW>
__global__ void __launch_bounds__(kThreads)
guided_wta_stream_kernel(const uint8_t* __restrict__ gray1,
                         const uint8_t* __restrict__ gray2,
                         float* __restrict__ best_out,
                         float* __restrict__ dmap_out, Params p, int band) {
  extern __shared__ float smem[];
  const Geom g = geometry(TW, p.R, band, p.D);
  const int P = g.P, R = p.R, H = p.H, W = p.W, RING = g.RING, PQ = g.PQ;
  const int k = 2 * R + 1;
  float* cost = smem;                        // cost, I*cost: kStep x PE each
  float* x1 = cost + 2 * kStep * g.PE;       // their x-sums: 2 rings of RING x PM
  float* ab = x1 + 2 * RING * g.PM;          // a, b: kStep x PM each
  float* x2 = ab + 2 * kStep * g.PM;         // their x-sums: 2 rings of RING x PQ
  float* qs = x2 + 2 * RING * PQ;            // box(a), box(b): kStep x PQ each
  float* gsum = smem;                        // guide x-sums (2 x (CH + 2R) x PM), before the walk
  float* mean_i = smem + g.walk;             // guide statistics: MB x MC each
  float* c_i = mean_i + g.MB * g.MC;
  uint8_t* i1s = reinterpret_cast<uint8_t*>(c_i + g.MB * g.MC);   // NR x I1C
  uint8_t* i2s = i1s + g.NR * g.I1C;                                // NR x I2C

  const size_t frame = (size_t)blockIdx.z * H * W;
  gray1 += frame;
  gray2 += frame;
  best_out += frame;
  dmap_out += frame;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * band;
  const int ye = y0 - P, xe = x0 - P;        // global origin of the band's E rows / columns
  const int ym = y0 - R, xm = x0 - R;        // global origin of its M rows / columns

  // Input windows of the whole band, zero outside the image.  i1s column
  // c holds global column xe - 1 + c; i2s column c holds xe + dmin - 1 + c.
  for (int r = threadIdx.y; r < g.NR; r += kBlockY) {
    const int gy = ye + r;
    const bool row_in = gy >= 0 && gy < H;
    for (int c = threadIdx.x; c < g.I1C; c += kTileW) {
      const int gx = xe - 1 + c;
      i1s[r * g.I1C + c] = (row_in && gx >= 0 && gx < W) ? gray1[(size_t)gy * W + gx] : 0;
    }
    for (int c = threadIdx.x; c < g.I2C; c += kTileW) {
      const int gx = xe + p.dmin - 1 + c;
      i2s[r * g.I2C + c] = (row_in && gx >= 0 && gx < W) ? gray2[(size_t)gy * W + gx] : 0;
    }
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
      for (int t = tid; t < rows * nblk; t += kThreads) {
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
    for (int t = tid; t < g.MC * nblk; t += kThreads) {
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

  const int nsteps = (g.NR + kStep - 1) / kStep;
  for (int s = 0; s < p.D; ++s) {
    const int d = p.dmin + s;
    for (int t = 0; t < nsteps; ++t) {
      const int i0 = t * kStep;               // E row of the step's first new row
      const int ns = min(kStep, g.NR - i0);

      // 1. cost and I*cost of the new rows over E (zero outside the
      // image, the out-of-range class where the match column leaves [0, W)).
      for (int e = tid; e < ns * g.EC; e += kThreads) {
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
        cost[(kStep + lr) * g.PE + c] = iv * cv;
      }
      __syncthreads();

      // 2. x-sums of both planes into ring X1 (slot = E row % RING).
      {
        const int nblk = (g.MC + kRB - 1) / kRB;
        for (int e = tid; e < ns * nblk; e += kThreads) {
          const int lr = e % ns, c0 = (e / ns) * kRB;
          const int nv = min(kRB, g.MC - c0);
          float s1[kRB], s2[kRB];
          window_sums<kRB>(cost + lr * g.PE + c0, 1, k, nv, s1);
          window_sums<kRB>(cost + (kStep + lr) * g.PE + c0, 1, k, nv, s2);
          float* da = x1 + ((i0 + lr) % RING) * g.PM + c0;
          float* db = da + RING * g.PM;
#pragma unroll
          for (int i = 0; i < kRB; ++i)
            if (i < nv) {
              da[i] = s1[i];
              db[i] = s2[i];
            }
        }
      }
      __syncthreads();

      // 3. a/b rows whose windows end in this step's rows: M row m needs
      // E rows m .. m + 2R.
      const int m_lo = max(0, i0 - P), m_hi = min(g.MB, i0 + ns - P);
      const int nm = m_hi - m_lo;
      if (nm > 0) {
        const int nblk = (nm + kRB - 1) / kRB;
        for (int e = tid; e < g.MC * nblk; e += kThreads) {
          const int c = e % g.MC, m0 = m_lo + (e / g.MC) * kRB;
          const int nv = min(kRB, m_hi - m0);
          const float* ra = x1 + c;
          const float* rb = ra + RING * g.PM;
          const int slot0 = m0 % RING;
          auto ring = [&](const float* plane, int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * g.PM];
          };
          float s1[kRB], s2[kRB];
          window_sums<kRB>([&](int j) { return ring(ra, j); }, k, nv, s1);
          window_sums<kRB>([&](int j) { return ring(rb, j); }, k, nv, s2);
#pragma unroll
          for (int i = 0; i < kRB; ++i) {
            if (i >= nv) break;
            const int m = m0 + i, gy = ym + m, gx = xm + c;
            float a = 0.f, b = 0.f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
              guided_ab(s1[i], s2[i], window_area(gy, gx, H, W, R),
                        mean_i[m * g.MC + c], c_i[m * g.MC + c], a, b);
            ab[(m - m_lo) * g.PM + c] = a;
            ab[(kStep + m - m_lo) * g.PM + c] = b;
          }
        }
      }
      __syncthreads();

      // 4. x-sums of a, b over the tile columns into ring X2 (slot = M
      // row % RING).
      if (nm > 0) {
        constexpr int nblk = TW / kRB;
        for (int e = tid; e < nm * nblk * 2; e += kThreads) {
          const int lr = e % nm, rest = e / nm;
          const int c0 = (rest % nblk) * kRB, pl = rest / nblk;
          float sx[kRB];
          window_sums<kRB>(ab + (pl * kStep + lr) * g.PM + c0, 1, k, kRB, sx);
          float* dst = x2 + pl * RING * PQ + ((m_lo + lr) % RING) * PQ + c0;
#pragma unroll
          for (int i = 0; i < kRB; ++i) dst[i] = sx[i];
        }
      }
      __syncthreads();

      // 5. y-sums over X2 -> box(a), box(b) of the output rows whose
      // windows end in this step's a/b rows: output row o needs M rows
      // o .. o + 2R.
      const int o_lo = max(0, m_lo - P), o_hi = min(band, m_hi - P);
      const int nq = o_hi - o_lo;
      if (nq > 0) {
        const int nblk = (nq + kRB - 1) / kRB;
        for (int e = tid; e < TW * nblk * 2; e += kThreads) {
          const int c = e % TW, rest = e / TW;
          const int o0 = o_lo + (rest % nblk) * kRB, pl = rest / nblk;
          const int nv = min(kRB, o_hi - o0);
          const float* plane = x2 + pl * RING * PQ + c;
          const int slot0 = o0 % RING;
          float sy[kRB];
          window_sums<kRB>([&](int j) {
            int sl = slot0 + j;
            if (sl >= RING) sl -= RING;
            return plane[sl * PQ];
          }, k, nv, sy);
#pragma unroll
          for (int i = 0; i < kRB; ++i)
            if (i < nv) qs[(pl * kStep + o0 + i - o_lo) * PQ + c] = sy[i];
        }
      }
      __syncthreads();

      // 6. q and the WTA update; the running (best, dmap) live in the
      // output arrays (slice 0 starts from best_init()).  No barrier after
      // it: the next step writes cost, X1, ab and X2 first and qs only
      // after four barriers; each output has one owner thread, the same
      // in every slice.
      for (int e = tid; e < nq * TW; e += kThreads) {
        const int lr = e / TW, c = e % TW, o = o_lo + lr;
        const int gy = y0 + o, gx = x0 + c;
        if (gy >= H || gx >= W) continue;
        const float area = window_area(gy, gx, H, W, R);
        const float iv = (float)i1s[(o + P) * g.I1C + c + P + 1];
        const float q = (qs[lr * PQ + c] / area) * iv + qs[(kStep + lr) * PQ + c] / area;
        const size_t at = (size_t)gy * W + gx;
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

template <int TW>
cudaError_t launch(const uint8_t* gray1, const uint8_t* gray2, float* best,
                   float* dmap, int N, int band, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TW, p.R, band, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      guided_wta_stream_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + TW - 1) / TW, (p.H + band - 1) / band, N);
  guided_wta_stream_kernel<TW><<<grid, dim3(kTileW, kBlockY), smem, stream>>>(
      gray1, gray2, best, dmap, p, band);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K1 needs for a tile width (32 or 64), a radius, a
// band height and a slice count (bytes).  The wrapper picks the band with it.
extern "C" long long guided_wta_stream_smem_bytes(int TW, int R, int band, int D) {
  return (long long)smem_bytes(TW, R, band, D);
}

// Launches K1 on `stream`.  gray1/gray2: uint8 (N, H, W) contiguous;
// best/dmap: float32 (N, H, W).  TW (output columns per CTA) must be 32
// or 64, band (output rows per CTA) >= 1.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int guided_wta_stream_launch(const void* gray1, const void* gray2,
                                        void* best, void* dmap, int N, int H,
                                        int W, int dmin, int D, int R, int TW,
                                        int band, float one_m_alpha, float alpha,
                                        float th_color, float th_grad, float oob,
                                        double eps, void* stream) {
  if (band < 1) return (int)cudaErrorInvalidValue;
  const Params p = make_params(H, W, dmin, D, R, one_m_alpha, alpha, th_color,
                               th_grad, oob, eps);
  const auto* g1 = static_cast<const uint8_t*>(gray1);
  const auto* g2 = static_cast<const uint8_t*>(gray2);
  auto* b = static_cast<float*>(best);
  auto* m = static_cast<float*>(dmap);
  auto st = static_cast<cudaStream_t>(stream);
  switch (TW) {
    case 32: return (int)launch<32>(g1, g2, b, m, N, band, p, st);
    case 64: return (int)launch<64>(g1, g2, b, m, N, band, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
