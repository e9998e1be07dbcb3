// Half-band decimation cascade of the log-VQT front end, all levels in one launch.
//
// Replaces: zeronotesamba_tpu/ops/pallas/vqt_kernel.py, _cascade_kernel
// (launched by decimation_cascade_pallas). The TPU kernel wrote each level as
// banded (256 >> s)-wide matrix products so the MXU could run it, and only
// the first 3-5 of the 7 levels fit its VMEM. Here every level is a
// polyphase FIR in float32 on the CUDA cores and all levels run in one launch.
//
// Function: level s+1 = the 81-tap half-band filter at stride 2 over level s,
//     y[m] = sum_k x[2m + k - 40] * taps[k],  k = 0..80,
// where samples outside [0, len_s) read as zero at every level (the zero row
// pad of the TPU kernel). Level s has len0 >> s samples.
//
// Polyphase form. Of the 81 Kaiser half-band taps only 41 are non-zero: the
// centre c and 20 exactly symmetric pairs p_q at offsets +-(2q+1). The 40
// taps at even offsets are sinc zeros (|tap| < 2e-17 in float32); the
// wrapper checks both facts before it drops them. With a level split into
// its even samples E[n] = x[2n] and its odd samples O[n] = x[2n+1],
//     y[m] = sum_{q=19..0} p_q O[m-1-q] + c E[m] + sum_{q=0..19} p_q O[m+q]:
// the centre reads only the even phase, the pairs only the odd phase, at
// unit stride. The 41 terms are one FMA chain in tap order, the order of
// the 81-tap convolution the plain path runs (cuDNN's F.conv1d), so the two
// agree to the bit but for the dropped zeros. Folding each pair first,
// p_q (O[m-1-q] + O[m+q]), takes as many instructions (21 FMAs, 20 adds) and
// moves each sample by about an ulp; the log-VQT's near-empty cells, whose
// sums cancel about 1e4 times over, turn that into 1.4e-3 in the log
// against the plain path at batch 32 x 10 s on an H100, past its 5e-4.
//
// Bound on this card: bytes. 82 FLOPs (41 taps) per output sample and about
// len0 outputs per row over all levels, against 8 bytes per output (the
// input read once, the levels written once): 10 FLOP/byte, below the
// float32 ridge of 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design.
// - Shared memory holds each level as its E half and its O half. A thread
//   computes kOut = 4 consecutive outputs: one float4 of E and 11 float4 of
//   O (its 44-sample odd window) go to registers, so 4 outputs cost 12
//   shared loads, each warp-wide load conflict-free (consecutive lanes read
//   consecutive 16-byte words). Outputs go straight into the E/O halves the
//   next level reads (two float2 stores). The taps are a by-value kernel
//   argument: every lane reads the same tap, from the constant bank, with no
//   shared-memory traffic.
// - Tiling: halo recompute, not thread-block clusters. A block owns kTile0 =
//   8,192 level-0 samples of one row and recomputes the halo the deeper
//   levels need (H[s-1] = 2 H[s] + 40, 5,080 level-0 samples each side at 7
//   levels), so blocks are independent and all 7 levels run in one launch.
//   A cluster could pass halos between its blocks through distributed shared
//   memory, but its two edge blocks would still need the full halo, and every
//   level would add a cluster-wide barrier; the arithmetic the halo adds
//   (about 1.2x at level 1) is cheap next to that in a kernel this far below
//   its operations bound.
// - Two adjacent levels live in shared memory at a time (ping-pong buffers,
//   107 KB at 7 levels), so two blocks of 256 threads fit on an SM; the
//   main path's batch 2 x 30 s gives 134 blocks, batch 32 x 10 s 896, a
//   0.5 s clip 10.
// - Each block writes only the samples it owns, into one packed output row
//   holding levels 1..n back to back. Every sample is computed with the same
//   order of sums by whichever block computes it, so results do not depend
//   on the tiling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 20;           // non-zero tap pairs
constexpr int kReach = 2 * kPairs;   // level-(s-1) halo one more level needs, each side
constexpr int kMaxLevels = 7;
constexpr int kTile0 = 8192;         // level-0 samples owned by one block
constexpr int kThreads = 256;
constexpr int kOut = 4;              // consecutive outputs per thread
constexpr int kWin = kOut + 2 * kPairs;  // odd-phase samples those outputs read
constexpr int kLoadBatch = 6;        // float4 loads in flight per thread for level 0
constexpr int kMaxDevices = 64;

struct Taps {
  float centre;
  float pair[kPairs];  // pair[q]: the tap at offsets -(2q+1) and +(2q+1)
};

__host__ __device__ inline void halos(int n_levels, int* h) {
  h[n_levels] = 0;
  for (int s = n_levels; s > 0; --s) h[s - 1] = 2 * h[s] + kReach;
}

// Level s of one block covers samples [tile * (kTile0 >> s) - h[s], +len(s)).
__host__ __device__ inline int level_len(int s, const int* h) { return (kTile0 >> s) + 2 * h[s]; }

// Local sample j of level s-1 is global 2 g_s - 40 + j, where g_s is level
// s's first sample; so output i of level s reads E[i + 20] and O[i .. i + 39].
__global__ void __launch_bounds__(kThreads, 2)
cascade_kernel(const float* __restrict__ x, float* __restrict__ out, const Taps taps, int64_t len0,
               int n_levels, int64_t out_row_stride, int buf0_len) {
  extern __shared__ __align__(16) float smem[];
  float* bufs[2] = {smem, smem + buf0_len};

  int h[kMaxLevels + 1];
  halos(n_levels, h);
  const int64_t row = blockIdx.y;
  const int64_t tile = blockIdx.x;

  // Level 0 with its halo, split into E and O; zero outside [0, len0).
  {
    const int half = level_len(0, h) / 2;
    float2* e = reinterpret_cast<float2*>(bufs[0]);
    float2* o = reinterpret_cast<float2*>(bufs[0] + half);
    const int64_t g0 = tile * kTile0 - h[0];
    const float* xr = x + row * len0;
    const int n4 = half / 2;
    for (int q0 = threadIdx.x; q0 < n4; q0 += kThreads * kLoadBatch) {
      float4 v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * kThreads;
        const int64_t n = g0 + 4 * static_cast<int64_t>(q);
        v[u] = (q < n4 && n >= 0 && n < len0) ? __ldg(reinterpret_cast<const float4*>(xr + n))
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int q = q0 + u * kThreads;
        if (q < n4) {
          e[q] = make_float2(v[u].x, v[u].z);
          o[q] = make_float2(v[u].y, v[u].w);
        }
      }
    }
  }
  __syncthreads();

  int64_t out_off = 0;
  for (int s = 1; s <= n_levels; ++s) {
    const float* e_in = bufs[(s - 1) & 1];
    const float* o_in = e_in + level_len(s - 1, h) / 2;
    const int r_s = level_len(s, h);
    float2* e_out = reinterpret_cast<float2*>(bufs[s & 1]);
    float2* o_out = reinterpret_cast<float2*>(bufs[s & 1] + r_s / 2);
    const int64_t len_s = len0 >> s;
    const int owned = kTile0 >> s;
    const int64_t g_s = tile * owned - h[s];
    float* orow = out + row * out_row_stride + out_off;
    const bool deepest = s == n_levels;
    for (int t = threadIdx.x; t < r_s / kOut; t += kThreads) {
      const int i0 = kOut * t;
      float w[kWin];
#pragma unroll
      for (int v = 0; v < kWin / 4; ++v) {
        const float4 f = *reinterpret_cast<const float4*>(o_in + i0 + 4 * v);
        w[4 * v] = f.x;
        w[4 * v + 1] = f.y;
        w[4 * v + 2] = f.z;
        w[4 * v + 3] = f.w;
      }
      const float4 ev = *reinterpret_cast<const float4*>(e_in + i0 + kPairs);
      const float e[kOut] = {ev.x, ev.y, ev.z, ev.w};
      float y[kOut];
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int q = kPairs - 1; q >= 0; --q) acc = fmaf(w[r + kPairs - 1 - q], taps.pair[q], acc);
        acc = fmaf(e[r], taps.centre, acc);
#pragma unroll
        for (int q = 0; q < kPairs; ++q) acc = fmaf(w[r + kPairs + q], taps.pair[q], acc);
        const int64_t n = g_s + i0 + r;
        y[r] = (n >= 0 && n < len_s) ? acc : 0.0f;
      }
      if (!deepest) {
        e_out[t] = make_float2(y[0], y[2]);
        o_out[t] = make_float2(y[1], y[3]);
      }
      // Owned groups: h[s] and owned are multiples of kOut, and the output
      // offsets and len_s are even, so the pairs below are float2-aligned.
      if (i0 >= h[s] && i0 < h[s] + owned) {
        const int64_t n0 = g_s + i0;
        if (n0 < len_s) *reinterpret_cast<float2*>(orow + n0) = make_float2(y[0], y[1]);
        if (n0 + 2 < len_s) *reinterpret_cast<float2*>(orow + n0 + 2) = make_float2(y[2], y[3]);
      }
    }
    __syncthreads();
    out_off += len_s;
  }
}

// Shared memory the kernel needs for n_levels >= 1 levels, in bytes.
int smem_bytes(int n_levels) {
  int h[kMaxLevels + 1];
  halos(n_levels, h);
  return (level_len(0, h) + level_len(1, h)) * static_cast<int>(sizeof(float));
}

// Raise the kernel's dynamic shared-memory limit to what 7 levels need, once
// per device and process.
cudaError_t set_up_once() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxLevels));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cascade_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// x: (batch, len0) float32, 16-byte aligned, len0 % 256 == 0.
// out: (batch, out_row_stride) float32, out_row_stride even, levels 1..n_levels
// packed in each row (level s at offset sum_{r<s} len0 >> r, length len0 >> s).
// taps21: [centre, pair_0 .. pair_19] of the half-band filter (host memory).
// Returns cudaGetLastError() after the launch.
int zns_cascade(const void* x, void* out, const float* taps21, long long batch, long long len0, int n_levels,
                long long out_row_stride, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1 || batch > 65535 || len0 < 1 || len0 % 256 != 0 ||
      out_row_stride % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_up_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps taps;
  taps.centre = taps21[0];
  for (int q = 0; q < kPairs; ++q) taps.pair[q] = taps21[1 + q];
  int h[kMaxLevels + 1];
  halos(n_levels, h);
  const long long tiles = (len0 + kTile0 - 1) / kTile0;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  cascade_kernel<<<grid, kThreads, smem_bytes(n_levels), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), taps, static_cast<int64_t>(len0), n_levels,
      static_cast<int64_t>(out_row_stride), level_len(0, h));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
