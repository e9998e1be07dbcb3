// Half-band decimation cascade of the log-VQT front end, all levels in one launch.
//
// Replaces: zeronotesamba_tpu/ops/pallas/vqt_kernel.py, _cascade_kernel
// (launched by decimation_cascade_pallas). The TPU kernel wrote each level as
// banded (256 >> s)-wide matrix products so the MXU could run it, and only
// the first 3-5 of the 7 levels fit its VMEM. Here every level is a direct
// strided FIR in float32 FMA and all levels run in one launch.
//
// Function: level s+1 = the 81-tap half-band filter at stride 2 over level s,
//     y[m] = sum_k x[2m + k - 40] * taps[k],  k = 0..80,
// where samples outside [0, len_s) read as zero at every level (the zero row
// pad of the TPU kernel). Level s has len0 >> s samples.
//
// Bound on this card: 162 FLOPs per output sample; the levels together write
// about as many samples as the input holds, so the call does about 162 FLOPs
// per 8 bytes moved (20 FLOP/byte), right at the float32 ridge of the card
// (67 TFLOP/s over 3.35 TB/s). Both bounds are microseconds at the main
// path's sizes; what limits a simple kernel is parallelism, since a loop
// over levels per row would occupy only B of the 132 SMs.
//
// Design: blocks over (tile, row). Each block owns kTile0 level-0 samples
// (kTile0 >> s samples of level s) and recomputes the halo the deeper levels
// need (H[s-1] = 2 H[s] + 40 samples each side of level s-1), so no block
// waits for another. Two adjacent levels live in shared memory at a time
// (ping-pong buffers of R_0 and R_1 floats, 110 KB at 7 levels); the halo
// adds about 1.2x the owned FMAs (2.2x in all). Each block writes only the samples it
// owns, into one packed output row holding levels 1..n back to back. Every
// sample is computed with the same tap order by whichever block computes it,
// so results do not depend on the tiling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 81;
constexpr int kHalf = kTaps / 2;
constexpr int kMaxLevels = 7;
constexpr int kTile0 = 8192;   // level-0 samples owned by one block
constexpr int kThreads = 512;
constexpr int kTapsSmem = 96;  // taps slot in shared memory, padded

__host__ __device__ inline void halos(int n_levels, int* h) {
  h[n_levels] = 0;
  for (int s = n_levels; s > 0; --s) h[s - 1] = 2 * h[s] + kHalf;
}

__global__ void __launch_bounds__(kThreads)
cascade_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ taps,
               int64_t len0, int n_levels, int64_t out_row_stride, int buf0_len) {
  extern __shared__ float smem[];
  float* s_taps = smem;
  float* bufs[2] = {smem + kTapsSmem, smem + kTapsSmem + buf0_len};

  int h[kMaxLevels + 1];
  halos(n_levels, h);

  const int64_t row = blockIdx.y;
  const int64_t tile = blockIdx.x;
  for (int i = threadIdx.x; i < kTaps; i += blockDim.x) s_taps[i] = taps[i];

  // Level 0 with its halo; zero outside [0, len0).
  {
    const int64_t g0 = tile * kTile0 - h[0];
    const int r0 = kTile0 + 2 * h[0];
    const float* xr = x + row * len0;
    float* dst = bufs[0];
    for (int i = threadIdx.x; i < r0; i += blockDim.x) {
      const int64_t n = g0 + i;
      dst[i] = (n >= 0 && n < len0) ? xr[n] : 0.0f;
    }
  }
  __syncthreads();

  int64_t out_off = 0;
  for (int s = 1; s <= n_levels; ++s) {
    const float* src = bufs[(s - 1) & 1];
    float* dst = bufs[s & 1];
    const int64_t len_s = len0 >> s;
    const int owned = kTile0 >> s;
    const int r_s = owned + 2 * h[s];
    // Element i of this level is sample g_s + i; it reads src[2i .. 2i+80].
    const int64_t g_s = tile * owned - h[s];
    float* orow = out + row * out_row_stride + out_off;
    for (int i = threadIdx.x; i < r_s; i += blockDim.x) {
      const float* p = src + 2 * i;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = fmaf(p[k], s_taps[k], acc);
      const int64_t n = g_s + i;
      const bool inside = n >= 0 && n < len_s;
      dst[i] = inside ? acc : 0.0f;
      if (inside && i >= h[s] && i < h[s] + owned) orow[n] = acc;
    }
    __syncthreads();
    out_off += len_s;
  }
}

// Shared memory the kernel needs for n_levels >= 1 levels, in bytes.
int smem_bytes(int n_levels) {
  int h[kMaxLevels + 1];
  halos(n_levels, h);
  const int r0 = kTile0 + 2 * h[0];
  const int r1 = (kTile0 >> 1) + 2 * h[1];
  return (kTapsSmem + r0 + r1) * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" {

// x: (batch, len0) float32, len0 % (1 << n_levels) == 0.
// out: (batch, out_row_stride) float32, levels 1..n_levels packed in each row
// (level s at offset sum_{r<s} len0 >> r, length len0 >> s).
// taps: (81,) float32. Returns cudaGetLastError() after the launch.
int zns_cascade(const void* x, void* out, const void* taps, long long batch, long long len0,
                int n_levels, long long out_row_stride, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1 || batch > 65535 || len0 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(n_levels);
  cudaError_t err = cudaFuncSetAttribute(cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int h[kMaxLevels + 1];
  halos(n_levels, h);
  const int buf0_len = kTile0 + 2 * h[0];
  const long long tiles = (len0 + kTile0 - 1) / kTile0;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  cascade_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(taps),
      static_cast<int64_t>(len0), n_levels, static_cast<int64_t>(out_row_stride), buf0_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
