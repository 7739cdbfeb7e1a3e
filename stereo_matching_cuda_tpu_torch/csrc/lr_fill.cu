// K2: left-right consistency check + occlusion fill, rows staged in
// shared memory, on Hopper (sm_90a).
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
//     trunc(v) < v_min get max(label of the nearest valid pixel to the
//     left, that of the nearest valid pixel to the right), v_min for a
//     side with none.  A pixel is valid where v >= v_min; its label is
//     clamp(trunc(v) - dmin, 0, D-1) + dmin (ops/occlusion.py:89-98, which
//     packs position and label into one key; the nearest valid pixel is
//     the one of largest key, so scanning positions gives the same label).
//
// Design.  The TPU kernel computes the gather as a select tree over D
// rolled copies of dR and the scans as log-doubling lane rolls.  Here a
// CTA of 256 threads owns two rows, 128 threads each (one row of 256
// threads where two rows' shared memory does not fit one block):
//   1. dL and dR are staged into shared memory with coalesced 16-byte
//      loads (a scalar head and tail where the row is not 16-byte aligned;
//      the shared row image is shifted to the global row's alignment);
//   2. each thread runs the LR check over a contiguous run of the row
//      from shared memory, the gather included, leaves the occlusion map
//      in place of dL and notes the run's first and last valid pixel.
//      The run length is odd, so the 32 lanes of a warp read 32
//      different banks;
//   3. the nearest valid positions before and after each run come from a
//      warp-shuffle scan of the run results and a scan over the row's
//      warps in shared memory; the occlusion map is written back with
//      16-byte stores;
//   4. each thread walks its run forward (label of the nearest valid pixel
//      to the left, kept in place of dR) and backward (to the right), and
//      leaves the filled row in place of dR, which is written back with
//      16-byte stores.
// So every global access is coalesced and the row is read and written
// once; the dynamic shared-memory limit is raised once per size and
// device, not on every launch.  Two rows of 128 threads ran 8% faster
// than one row of 256 at 6 MP and no slower at 288x384; 4 and 8 rows
// ran slower (PERF.md, Findings: K2 and K1 redesigned).
//
// What bounds it on the H100: device memory, 16 bytes per pixel (two
// float maps in, two out) and a few integer operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;                  // pixels of a run loaded before any is stored
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int W, dmin, D, d_lr, d_occlusion, v_min;
};

// Floats of one shared row image: W plus up to 3 of shift, rounded up to
// whole 16-byte vectors so the second image stays aligned.
__host__ __device__ inline int row_floats(int W) { return (W + 3 + 3) & ~3; }

__device__ inline bool fill_valid(float v, const Params& p) {
  return v >= (float)p.v_min;              // float compare, occlusion.cu:152
}

__device__ inline float fill_label(float v, const Params& p) {
  return (float)(min(max((int)v - p.dmin, 0), p.D - 1) + p.dmin);
}

// The NT threads of a row copy n floats from global src to shared dst,
// and from src2 to dst2, with both loads in flight before either store:
// the `head` floats before the first 16-byte boundary and the tail one at
// a time, the rest as float4.  Each dst lies at its src's address modulo
// 16.
template <int NT>
__device__ inline void stage_rows(float* __restrict__ dst, const float* __restrict__ src,
                                  float* __restrict__ dst2, const float* __restrict__ src2,
                                  int n, int head, int t) {
  head = min(head, n);
  const int nvec = (n - head) >> 2;
  for (int i = t; i < head; i += NT) {
    const float x = src[i], y = src2[i];
    dst[i] = x;
    dst2[i] = y;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  const float4* s24 = reinterpret_cast<const float4*>(src2 + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  float4* d24 = reinterpret_cast<float4*>(dst2 + head);
  for (int i = t; i < nvec; i += NT) {
    const float4 x = s4[i], y = s24[i];
    d4[i] = x;
    d24[i] = y;
  }
  for (int i = head + 4 * nvec + t; i < n; i += NT) {
    const float x = src[i], y = src2[i];
    dst[i] = x;
    dst2[i] = y;
  }
}

// The NT threads of a row store n floats from shared src to global dst,
// as stage_rows does.
template <int NT>
__device__ inline void store_row(float* __restrict__ dst, const float* __restrict__ src,
                                 int n, int head, int t) {
  head = min(head, n);
  const int nvec = (n - head) >> 2;
  for (int i = t; i < head; i += NT) dst[i] = src[i];
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = t; i < nvec; i += NT) d4[i] = s4[i];
  for (int i = head + 4 * nvec + t; i < n; i += NT) dst[i] = src[i];
}

// TPR threads per row, kThreads / TPR rows per CTA.
template <int TPR>
__global__ void __launch_bounds__(kThreads)
lr_fill_kernel(const float* __restrict__ dl, const float* __restrict__ dr,
               float* __restrict__ occ_out, float* __restrict__ fill_out, Params p,
               int rows, int vec) {
  constexpr int RPC = kThreads / TPR, WPR = TPR / 32;
  extern __shared__ float4 smem4[];
  __shared__ int warp_last[kWarps], warp_first[kWarps];

  const int W = p.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid / TPR, t = tid % TPR, w0 = sub * WPR;   // row in the CTA, its first warp
  const int row = blockIdx.x * RPC + sub;
  const bool live = row < rows;
  const size_t off = (size_t)row * W;
  // With every array 16-byte aligned (vec), the row starts `mis` floats
  // past a 16-byte boundary; its image in shared memory starts as far past
  // one, so both sides of each copy share their alignment.
  const int mis = vec ? (int)(off & 3) : 0;
  const int head = vec ? ((4 - mis) & 3) : W;
  float* a = reinterpret_cast<float*>(smem4) + 2 * sub * row_floats(W) + mis;  // dL, then occ
  float* b = a + row_floats(W);                                     // dR, then the filled row

  if (live) stage_rows<TPR>(a, dl + off, b, dr + off, W, head, t);
  __syncthreads();

  // LR check over this thread's run [xb, xe), in place of dL, and the
  // run's first and last valid pixel.  The gather reads dR only.  Each
  // chunk of the run is loaded before any of it is stored, so the loads
  // overlap (a store to `a` could alias a later load for all the compiler
  // knows).
  const int run = ((W + TPR - 1) / TPR) | 1;
  const int xb = live ? min(W, t * run) : W, xe = min(W, xb + run);
  int last = -1, first = W;
  for (int x0 = xb; x0 < xe; x0 += kChunk) {
    float v[kChunk], dprime[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = x0 + j < xe ? a[x0 + j] : 0.f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int d = (int)v[j], xs = x0 + j + d;      // trunc toward zero
      dprime[j] = xs >= 0 && xs < W && d >= p.dmin && d < p.dmin + p.D ? b[xs] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int x = x0 + j, d = (int)v[j], xs = x + d;
      if (x >= xe) break;
      const bool in_range = xs >= 0 && xs < W;
      const bool bad = fabsf((float)d + dprime[j]) > (float)p.d_lr;
      const float o = (!in_range || bad) ? (float)p.d_occlusion : v[j];
      a[x] = o;
      if (fill_valid(o, p)) {
        last = x;
        first = min(first, x);
      }
    }
  }

  // The last valid pixel before the run and the first one after it: a
  // shuffle scan within the warp (prefix max of `last`, suffix min of
  // `first`), then the row's warps before and after this one.
  int inc_l = last, inc_f = first;
  for (int o = 1; o < 32; o <<= 1) {
    const int l = __shfl_up_sync(kFull, inc_l, o);
    const int f = __shfl_down_sync(kFull, inc_f, o);
    if (lane >= o) inc_l = max(inc_l, l);
    if (lane + o < 32) inc_f = min(inc_f, f);
  }
  int before = __shfl_up_sync(kFull, inc_l, 1);
  int after = __shfl_down_sync(kFull, inc_f, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = W;
  if (lane == 31) warp_last[warp] = inc_l;
  if (lane == 0) warp_first[warp] = inc_f;
  __syncthreads();
  for (int w = w0; w < warp; ++w) before = max(before, warp_last[w]);
  for (int w = warp + 1; w < w0 + WPR; ++w) after = min(after, warp_first[w]);
  if (live) store_row<TPR>(occ_out + off, a, W, head, t);

  // Forward over the run, a chunk at a time: the label of the nearest
  // valid pixel at or left of x, into b (dR is no longer read).  Backward:
  // the fill.  Each thread touches only its own run of b.
  float left = before >= 0 && xb < xe ? fill_label(a[before], p) : (float)p.v_min;
  for (int x0 = xb; x0 < xe; x0 += kChunk) {
    float o[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) o[j] = x0 + j < xe ? a[x0 + j] : 0.f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (x0 + j >= xe) break;
      if (fill_valid(o[j], p)) left = fill_label(o[j], p);
      b[x0 + j] = left;
    }
  }
  float right = after < W && xb < xe ? fill_label(a[after], p) : (float)p.v_min;
  for (int x1 = xe - 1; x1 >= xb; x1 -= kChunk) {
    float o[kChunk], l[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      o[j] = x1 - j >= xb ? a[x1 - j] : 0.f;
      l[j] = x1 - j >= xb ? b[x1 - j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (x1 - j < xb) break;
      if (fill_valid(o[j], p)) right = fill_label(o[j], p);
      b[x1 - j] = (int)o[j] < p.v_min ? fmaxf(l[j], right) : o[j];   // occlusion.cu:140-142
    }
  }
  __syncthreads();

  if (live) store_row<TPR>(fill_out + off, b, W, head, t);
}

template <int TPR>
cudaError_t launch(const float* dl, const float* dr, float* occ, float* fill, int rows,
                   const Params& p, int vec, cudaStream_t stream) {
  constexpr int RPC = kThreads / TPR;
  const int smem = RPC * 2 * row_floats(p.W) * (int)sizeof(float);
  // The limit each device's kernel was last raised to (0: the default).
  static int raised[64] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || raised[dev] < smem) {
      err = cudaFuncSetAttribute(lr_fill_kernel<TPR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (dev < 64) raised[dev] = smem;
    }
  }
  lr_fill_kernel<TPR><<<(rows + RPC - 1) / RPC, kThreads, smem, stream>>>(
      dl, dr, occ, fill, p, rows, vec);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one row (bytes).
extern "C" long long lr_fill_smem_bytes(int W) {
  return 2LL * row_floats(W) * (long long)sizeof(float);
}

// Launches K2 on `stream`.  dl/dr/occ/fill: float32 (rows, W) contiguous,
// one row's shared memory (lr_fill_smem_bytes) within a block's.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int lr_fill_launch(const void* dl, const void* dr, void* occ,
                              void* fill, int rows, int W, int dmin, int D,
                              int d_lr, int d_occlusion, int v_min, void* stream) {
  const Params p{W, dmin, D, d_lr, d_occlusion, v_min};
  const int vec = ((reinterpret_cast<uintptr_t>(dl) | reinterpret_cast<uintptr_t>(dr)
                    | reinterpret_cast<uintptr_t>(occ) | reinterpret_cast<uintptr_t>(fill))
                   & 15) == 0;
  const auto* l = static_cast<const float*>(dl);
  const auto* r = static_cast<const float*>(dr);
  auto* o = static_cast<float*>(occ);
  auto* f = static_cast<float*>(fill);
  auto st = static_cast<cudaStream_t>(stream);
  constexpr long long kSmemLimit = 232448;   // dynamic shared memory of one block
  return 2 * lr_fill_smem_bytes(W) <= kSmemLimit
             ? (int)launch<128>(l, r, o, f, rows, p, vec, st)
             : (int)launch<256>(l, r, o, f, rows, p, vec, st);
}
