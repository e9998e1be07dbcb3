// One octave of the log-VQT: framing, filterbank, magnitude and log in one pass.
//
// Replaces: zeronotesamba_tpu/ops/pallas/vqt_kernel.py, _octave_kernel
// (launched by octave_log_xqt_pallas, once per octave). On the TPU the
// overlapping frames were gathered by XLA before the kernel, because framing
// inside the kernel mis-lowered there, and the 24 live bank columns were
// padded to the 128-lane width. Here each block reads its frames straight
// from the level signal and holds only the 24 live columns.
//
// Function, for every batch row b and frame t < n_frames:
//     frame[k] = x[b, offset + t*hop + k],  k = 0..255
//     re_i = sum_k frame[k] * bank[k, i],  im_i = sum_k frame[k] * bank[k, 12 + i]
//     out[b, row0 + i, t] = log(sqrt(re_i^2 + im_i^2 + 1e-30) + log_eps),  i = 0..11
// written straight into the (B, 96, T) log-VQT, which fuses the transpose and
// the octave concatenation of the TPU wrapper.
//
// Bound on this card: 2 * 24 * 256 = 12,288 FLOPs per frame against about
// 4 * hop bytes of new signal and 48 bytes of output per frame. The top
// octave (hop 256, 11 FLOP/byte) sits just below the card's float32 ridge of
// 20 FLOP/byte; the 8 octaves together (40 FLOP/byte) are bound by
// operations, the 67 TFLOP/s float32 CUDA-core rate. The sums stay in
// float32 FMA on the CUDA cores, not TF32 or bf16: the log amplifies
// relative error in low-magnitude cells.
//
// Design: a block takes kFrames consecutive frames of one row. It stages the
// 256 x 24 bank (24 KB) and the frames' signal span ((kFrames-1)*hop + 256
// floats, at most 16 KB) in shared memory, so overlapping frames read each
// sample from device memory once. One thread per (frame, column) runs the
// 256-term dot product; threads of one warp share a frame, so the signal
// reads broadcast and the bank reads hit consecutive banks. The magnitude and
// log epilogue then writes runs of consecutive frames of one bin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 256;            // window length
constexpr int kBpo = 12;           // bins per octave
constexpr int kCols = 2 * kBpo;    // [cos | sin] bank columns
constexpr int kFrames = 16;        // frames per block
constexpr int kMaxHop = 256;
constexpr int kThreads = kFrames * kCols;  // 384

__global__ void __launch_bounds__(kThreads)
octave_kernel(const float* __restrict__ x, int64_t x_row_stride, int64_t offset, int hop, int n_frames,
              const float* __restrict__ bank, float* __restrict__ out, int64_t out_row_stride, int row0,
              float log_eps) {
  __shared__ float s_bank[kW * kCols];
  __shared__ float s_sig[(kFrames - 1) * kMaxHop + kW];
  __shared__ float s_resp[kFrames * kCols];

  const int64_t b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - t0);
  const int span = (nf - 1) * hop + kW;
  const float* xr = x + b * x_row_stride + offset + static_cast<int64_t>(t0) * hop;

  for (int i = threadIdx.x; i < kW * kCols; i += blockDim.x) s_bank[i] = bank[i];
  for (int i = threadIdx.x; i < span; i += blockDim.x) s_sig[i] = xr[i];
  __syncthreads();

  for (int idx = threadIdx.x; idx < nf * kCols; idx += blockDim.x) {
    const int f = idx / kCols;
    const int c = idx - f * kCols;
    const float* p = s_sig + f * hop;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kW; ++k) acc = fmaf(p[k], s_bank[k * kCols + c], acc);
    s_resp[idx] = acc;
  }
  __syncthreads();

  float* ob = out + b * out_row_stride + static_cast<int64_t>(row0) * n_frames + t0;
  for (int idx = threadIdx.x; idx < kBpo * kFrames; idx += blockDim.x) {
    const int i = idx / kFrames;
    const int f = idx - i * kFrames;
    if (f < nf) {
      const float re = s_resp[f * kCols + i];
      const float im = s_resp[f * kCols + kBpo + i];
      const float mag = sqrtf(re * re + im * im + 1e-30f);
      ob[static_cast<int64_t>(i) * n_frames + f] = logf(mag + log_eps);
    }
  }
}

}  // namespace

extern "C" {

// x: level signal, row b at x + b * x_row_stride; frame t reads
// x[b, offset + t*hop .. offset + t*hop + 255] (the caller checks the bounds).
// bank: (256, 24) float32 [cos | sin]. out: (batch, out_row_stride) float32,
// rows row0 .. row0+11 of n_frames each are written. Returns cudaGetLastError().
int zns_octave(const void* x, long long x_row_stride, long long offset, int hop, int n_frames,
               long long batch, const void* bank, void* out, long long out_row_stride, int row0,
               float log_eps, void* stream) {
  if (hop < 1 || hop > kMaxHop || n_frames < 1 || batch < 1 || batch > 65535 || offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((n_frames + kFrames - 1) / kFrames), static_cast<unsigned>(batch));
  octave_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int64_t>(x_row_stride), static_cast<int64_t>(offset), hop,
      n_frames, static_cast<const float*>(bank), static_cast<float*>(out),
      static_cast<int64_t>(out_row_stride), row0, log_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
