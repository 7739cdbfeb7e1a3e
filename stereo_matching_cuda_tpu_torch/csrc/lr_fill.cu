// K2: left-right consistency check + occlusion fill, one CTA per row,
// on Hopper (sm_90a).
//
// Replaces: stereo_matching_cuda_tpu/ops/pallas_post.py::_post_kernel
//   (launched by lr_fill_fused).
// Checked against: stereo_matching_cuda_tpu_torch/ops/fused_post.py::
//   lr_fill_reference (detect_occlusion then fill_occlusion), which it must
//   match BIT FOR BIT: it does integer compares and selects only.
//
// What it computes, per row:
//   LR check (occlusion.cu:3-15): d = trunc(dL[x]); occluded iff x+d is
//     outside [0, W) or |d + dR[x+d]| > d_lr, where dR[x+d] is read only
//     when d is one of the D labels [dmin, dmin+D) and is 0 otherwise (the
//     label-set semantics of ops/occlusion.py:46-60); occluded pixels get
//     d_occlusion.
//   Fill (occlusion.cu:134-176, deterministic semantics): pixels with
//     trunc(v) < v_min get max(nearest valid label to the left, nearest
//     valid label to the right), v_min for a side with none.  Nearest
//     valid is a running max of packed keys pos*D + clamp(code, 0, D-1)
//     (ops/occlusion.py:89-98), forward and backward.
//
// Design.  The TPU kernel computes the gather as a select tree over D
// rolled copies of dR and the scans as log-doubling lane rolls.  Here the
// gather is a direct load, and each scan is a per-thread serial scan over
// a contiguous run of the row, a warp-shuffle scan of the run totals and
// a cross-warp scan in shared memory.  W * D < 2^31 keeps keys in int32.
//
// What bounds it on the H100: device memory, 16 bytes per pixel (two
// float maps in, two out) and a few integer operations; it is a small
// share of a frame next to K1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int H, W, dmin, D, d_lr, d_occlusion, v_min;
};

// Packed fill key of value v at scan position pos, -1 when not valid.
__device__ inline int fill_key(float v, int pos, const Params& p) {
  if (!(v >= (float)p.v_min)) return -1;   // float compare, occlusion.cu:152
  const int code = min(max((int)v - p.dmin, 0), p.D - 1);
  return pos * p.D + code;
}

__device__ inline float unpack(int m, const Params& p) {
  return m >= 0 ? (float)(m % p.D + p.dmin) : (float)p.v_min;
}

__global__ void lr_fill_kernel(const float* __restrict__ dl,
                               const float* __restrict__ dr,
                               float* __restrict__ occ_out,
                               float* __restrict__ fill_out, Params p) {
  extern __shared__ int smem[];
  float* occ_s = reinterpret_cast<float*>(smem);   // the row's LR result
  int* fwd_s = smem + p.W;                         // forward running max
  __shared__ int warp_fwd[32], warp_bwd[32];

  const int W = p.W;
  const size_t row = (size_t)blockIdx.x * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int run = (W + kThreads - 1) / kThreads;
  const int xb = min(W, tid * run), xe = min(W, xb + run);

  // LR check over this thread's run, with the run's key totals.
  int tot_f = -1, tot_b = -1;
  for (int x = xb; x < xe; ++x) {
    const float v = dl[row + x];
    const int d = (int)v;                        // trunc toward zero
    const int xs = x + d;
    const bool in_range = xs >= 0 && xs < W;
    float dprime = 0.f;
    if (in_range && d >= p.dmin && d < p.dmin + p.D) dprime = dr[row + xs];
    const bool bad = fabsf((float)d + dprime) > (float)p.d_lr;
    const float o = (!in_range || bad) ? (float)p.d_occlusion : v;
    occ_out[row + x] = o;
    occ_s[x] = o;
    tot_f = max(tot_f, fill_key(o, x, p));
    tot_b = max(tot_b, fill_key(o, W - 1 - x, p));
  }

  // Inclusive warp scans: prefix max forward, suffix max backward.
  int inc_f = tot_f, inc_b = tot_b;
  for (int o = 1; o < 32; o <<= 1) {
    const int f = __shfl_up_sync(kFull, inc_f, o);
    const int b = __shfl_down_sync(kFull, inc_b, o);
    if (lane >= o) inc_f = max(inc_f, f);
    if (lane + o < 32) inc_b = max(inc_b, b);
  }
  if (lane == 31) warp_fwd[warp] = inc_f;
  if (lane == 0) warp_bwd[warp] = inc_b;
  __syncthreads();
  if (warp == 0) {
    int f = lane < nwarps ? warp_fwd[lane] : -1;
    int b = lane < nwarps ? warp_bwd[lane] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int tf = __shfl_up_sync(kFull, f, o);
      const int tb = __shfl_down_sync(kFull, b, o);
      if (lane >= o) f = max(f, tf);
      if (lane + o < 32) b = max(b, tb);
    }
    warp_fwd[lane] = f;
    warp_bwd[lane] = b;
  }
  __syncthreads();

  // Exclusive carries into this thread's run.
  int prev = __shfl_up_sync(kFull, inc_f, 1);
  int next = __shfl_down_sync(kFull, inc_b, 1);
  if (lane == 0) prev = -1;
  if (lane == 31) next = -1;
  int m_f = max(prev, warp > 0 ? warp_fwd[warp - 1] : -1);
  int m_b = max(next, warp + 1 < nwarps ? warp_bwd[warp + 1] : -1);

  // Serial scans over the run (occ_s/fwd_s entries are this thread's own).
  for (int x = xb; x < xe; ++x) {
    m_f = max(m_f, fill_key(occ_s[x], x, p));
    fwd_s[x] = m_f;
  }
  for (int x = xe - 1; x >= xb; --x) {
    const float o = occ_s[x];
    m_b = max(m_b, fill_key(o, W - 1 - x, p));
    const bool occluded = (int)o < p.v_min;     // occlusion.cu:140-142
    fill_out[row + x] = occluded ? fmaxf(unpack(fwd_s[x], p), unpack(m_b, p)) : o;
  }
}

}  // namespace

// Dynamic shared memory of one row (bytes).
extern "C" long long lr_fill_smem_bytes(int W) {
  return 2LL * W * (long long)sizeof(int);
}

// Launches K2 on `stream`.  dl/dr/occ/fill: float32 (H, W) contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int lr_fill_launch(const void* dl, const void* dr, void* occ,
                              void* fill, int H, int W, int dmin, int D,
                              int d_lr, int d_occlusion, int v_min,
                              void* stream) {
  const Params p{H, W, dmin, D, d_lr, d_occlusion, v_min};
  const size_t smem = (size_t)lr_fill_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      lr_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lr_fill_kernel<<<H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dl), static_cast<const float*>(dr),
      static_cast<float*>(occ), static_cast<float*>(fill), p);
  return (int)cudaGetLastError();
}
