// Every octave of the log-VQT in one launch: framing, filterbank, magnitude and log.
//
// Replaces: zeronotesamba_tpu/ops/pallas/vqt_kernel.py, _octave_kernel
// (launched by octave_log_xqt_pallas, once per octave). On the TPU the
// overlapping frames were gathered by XLA before the kernel, because framing
// inside the kernel mis-lowered there, the 24 live bank columns were padded
// to the 128-lane width, and each octave was its own call. Here one launch
// covers all octaves; each block frames its signal itself and holds only the
// 24 live columns.
//
// Function, for every plan entry p (an octave), batch row b and frame t < T:
//     frame[k] = src_p[b, start_p + t*hop_p + k],  k = 0..255
//     re_i = sum_k frame[k] * bank_p[k, i],  im_i = sum_k frame[k] * bank_p[k, 12 + i]
//     out[b, row_p + i, t] = log(sqrt(re_i^2 + im_i^2 + 1e-30) + log_eps),  i = 0..11
// where src_p is the full-rate signal x0 or the cascade's packed levels and
// start_p is the octave's level offset in that row plus its frame offset.
// The output is the final (B, 96, T) log-VQT, which fuses the transpose and
// the octave concatenation of the TPU wrapper.
//
// Bound on this card: 2 * 24 * 256 = 12,288 FLOPs per frame and octave,
// against about 4 * hop bytes of new signal and 48 bytes of output: the 8
// octaves together (about 40 FLOP/byte) are bound by operations, the 67
// TFLOP/s float32 CUDA-core rate. The sums stay in float32 FMA on the CUDA
// cores, not TF32 or bf16: the log amplifies relative error in low-magnitude
// cells.
//
// Design. The grid runs over (frame tile, plan entry, batch row); a block
// takes kFrames = 128 frames of one octave and row, and each of its 4 warps
// owns 32 of them.
// - Order of sums: every (frame, column) sum is one thread's FMA chain over
//   k = 0..255 in order, as cuBLAS's float32 product in the plain version
//   sums it at these shapes. In near-empty cells the sum cancels about 1e4
//   times over, and another order, such as k split over the warps, puts the
//   log up to 4e-4 away from the plain version there (batch 32 x 10 s on an
//   H100), past the 1e-4 the check allows, and no nearer to a float64
//   evaluation.
// - Staging, by cp.async: the octave's 256 x 24 bank, regrouped so that the
//   6 columns one thread needs (3 bins, re and im) for 4 consecutive k are 24
//   consecutive floats; and the frames in chunks of 32 k (128 frames x 32
//   floats, rows padded to 36) through a ring of 4 buffers, so that each
//   chunk is requested three chunks ahead of its sums and one barrier per
//   chunk suffices. Frames are copied 16 bytes at a time where the block's
//   frames all start 16-byte aligned (hop a multiple of 4), else 4 bytes.
//   The wrapper pads the packed levels' row stride to a multiple of 4
//   floats and every level starts at a multiple of 4, so with the log-VQT's
//   plan every batch row of every octave but the hop-2 one is aligned.
//   Writing frames out in full (im2col) instead of reading them in place
//   from the signal span keeps a warp's frame loads in distinct banks at
//   every hop; in place they would conflict 8 ways at hops of 32 and more.
// - Register tiling: a thread computes 4 frames x 3 bins x (re, im) = 24
//   sums. Per 4 values of k it loads 4 float4 of frames and 6 float4 of bank
//   and runs 96 FMAs. In a warp, 8 lanes take 8 frame groups (frames g,
//   g+8, g+16, g+24 of the warp's 32) and 4 lanes take 4 bin groups: a frame
//   load is shared by the 4 bin groups and a bank load by the 8 frame groups,
//   and neither conflicts.
// - The epilogue takes the magnitude and the log in registers and writes
//   each bin's frames; a warp whose frames all lie past the end skips its sums.
// - 96 KB of dynamic shared memory (set once per process), so two blocks of
//   128 threads fit on an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 256;               // window length
constexpr int kBpo = 12;              // bins per octave
constexpr int kCols = 2 * kBpo;       // [cos | sin] bank columns
constexpr int kFrames = 128;          // frames per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpFrames = kFrames / kWarps;
constexpr int kFG = 8;                // frame groups in a warp
constexpr int kBG = 4;                // bin groups in a warp
constexpr int kTM = kWarpFrames / kFG;  // frames per thread
constexpr int kTB = kBpo / kBG;       // bins per thread
constexpr int kGroupCols = 2 * kTB;   // bank columns per bin group
constexpr int kChunk = 32;            // k values per staged chunk of frames
constexpr int kChunks = kW / kChunk;
constexpr int kChunkRow = kChunk + 4;  // padded frame row of a chunk
constexpr int kChunkFloats = kFrames * kChunkRow;
constexpr int kStages = 4;            // chunk buffers in the ring
constexpr int kGroupStride = kW * kGroupCols + 4;  // padded bank floats per bin group
constexpr int kBankFloats = kBG * kGroupStride;
constexpr int kSmemBytes = (kStages * kChunkFloats + kBankFloats) * static_cast<int>(sizeof(float));
constexpr int kMaxPlan = 8;
constexpr int kMaxHop = 256;
constexpr int kMaxDevices = 64;

static_assert(kFG * kBG == 32, "a warp is frame groups x bin groups");

struct Plan {
  const float* src[kMaxPlan];  // row 0 of the entry's source, at its first frame
  int64_t src_stride[kMaxPlan];
  int hop[kMaxPlan];
  int row[kMaxPlan];
  int bank[kMaxPlan];
};

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most kStages - 2 committed groups are still in flight.
__device__ inline void cp_async_wait_ring() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory"); }

__global__ void __launch_bounds__(kThreads, 2)
octaves_kernel(const Plan plan, int n_frames, const float* __restrict__ banks, float* __restrict__ out,
               int64_t out_row_stride, float log_eps) {
  extern __shared__ __align__(16) float smem[];
  // Chunk c of frames lives in ring slot c % kStages: [kFrames][kChunkRow].
  float* s_bank = smem + kStages * kChunkFloats;  // [kBG][kW][kGroupCols] + pad per group

  const int p = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - t0);
  const int hop = plan.hop[p];
  const float* src = plan.src[p] + b * plan.src_stride[p] + static_cast<int64_t>(t0) * hop;
  const float* bank = banks + static_cast<int64_t>(plan.bank[p]) * kW * kCols;

  // Bank column c of row k -> bin group g = (c % 12) / 3, slot 2 (c % 3) + c / 12.
  for (int idx = threadIdx.x; idx < kW * kCols; idx += kThreads) {
    const int k = idx / kCols;
    const int c = idx - k * kCols;
    const int bin = c < kBpo ? c : c - kBpo;
    const int g = bin / kTB;
    const int slot = 2 * (bin - g * kTB) + (c < kBpo ? 0 : 1);
    cp_async4(s_bank + g * kGroupStride + k * kGroupCols + slot, bank + idx);
  }
  // Frame rows past the last frame read as zero; they are never written out.
  for (int idx = threadIdx.x; idx < (kFrames - nf) * kChunk; idx += kThreads) {
    const int f = nf + idx / kChunk;
    const int k = idx % kChunk;
#pragma unroll
    for (int r = 0; r < kStages; ++r) smem[r * kChunkFloats + f * kChunkRow + k] = 0.0f;
  }
  // 16-byte copies where every frame of the block starts 16-byte aligned.
  const bool vec = hop % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  auto stage = [&](int c) {
    if (c >= kChunks) return;
    float* dst = smem + (c % kStages) * kChunkFloats;
    const float* from = src + c * kChunk;
    if (vec) {
      for (int idx = threadIdx.x; idx < nf * (kChunk / 4); idx += kThreads) {
        const int f = idx / (kChunk / 4);
        const int k = 4 * (idx - f * (kChunk / 4));
        cp_async16(dst + f * kChunkRow + k, from + static_cast<int64_t>(f) * hop + k);
      }
    } else {
      for (int idx = threadIdx.x; idx < nf * kChunk; idx += kThreads) {
        const int f = idx / kChunk;
        const int k = idx - f * kChunk;
        cp_async4(dst + f * kChunkRow + k, from + static_cast<int64_t>(f) * hop + k);
      }
    }
  };
  for (int c = 0; c < kStages - 1; ++c) {
    stage(c);
    cp_async_commit();  // the first group holds the bank too
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int fg = lane % kFG;
  const int bg = lane / kFG;
  const int f_warp = warp * kWarpFrames;
  const bool active = f_warp < nf;

  float acc[kTM][kTB][2];
#pragma unroll
  for (int j = 0; j < kTM; ++j)
#pragma unroll
    for (int i = 0; i < kTB; ++i) acc[j][i][0] = acc[j][i][1] = 0.0f;

  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_ring();  // chunk c (and the bank) have landed
    __syncthreads();       // ... for every thread, and chunk c - 1 is summed
    stage(c + kStages - 1);  // into the slot chunk c - 1 used
    cp_async_commit();       // possibly empty, so that one wait rule holds throughout
    if (active) {
      const float* sig = smem + (c % kStages) * kChunkFloats + (f_warp + fg) * kChunkRow;
      const float* bk = s_bank + bg * kGroupStride + c * kChunk * kGroupCols;
#pragma unroll 2
      for (int k = 0; k < kChunk; k += 4) {
        float bv[4 * kGroupCols];
#pragma unroll
        for (int v = 0; v < kGroupCols; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(bk + k * kGroupCols + 4 * v);
          bv[4 * v] = q.x;
          bv[4 * v + 1] = q.y;
          bv[4 * v + 2] = q.z;
          bv[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kTM; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(sig + j * kFG * kChunkRow + k);
          const float sv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < kTB; ++i) {
              acc[j][i][0] = fmaf(sv[kk], bv[kk * kGroupCols + 2 * i], acc[j][i][0]);
              acc[j][i][1] = fmaf(sv[kk], bv[kk * kGroupCols + 2 * i + 1], acc[j][i][1]);
            }
        }
      }
    }
  }

  if (!active) return;
  float* ob = out + b * out_row_stride + static_cast<int64_t>(plan.row[p]) * n_frames + t0;
#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    const int f = f_warp + fg + j * kFG;
    if (f < nf) {
#pragma unroll
      for (int i = 0; i < kTB; ++i) {
        const float re = acc[j][i][0];
        const float im = acc[j][i][1];
        const float mag = sqrtf(re * re + im * im + 1e-30f);
        ob[static_cast<int64_t>(bg * kTB + i) * n_frames + f] = logf(mag + log_eps);
      }
    }
  }
}

// Raise the kernel's dynamic shared-memory limit, once per device and process.
cudaError_t set_up_once() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(octaves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(octaves_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// x0: (batch, x0_stride) full-rate signal; levels: (batch, levels_stride) the
// cascade's packed levels. plan: n_plan rows (host memory) of 6 int64
// (src, level_off, frame_off, hop, row, bank): entry p frames row b of x0
// (src 0) or of levels (src 1) from element level_off + frame_off, every hop
// samples, with bank `bank` of banks (n_banks, 256, 24) float32 [cos | sin],
// into rows row .. row+11 of out (batch, out_row_stride) float32, n_frames
// per row. The caller checks that every frame lies inside its source row.
// Returns cudaGetLastError() after the launch.
int zns_octaves(const void* x0, long long x0_stride, const void* levels, long long levels_stride,
                const long long* plan, int n_plan, int n_frames, long long batch, const void* banks, int n_banks,
                void* out, long long out_row_stride, float log_eps, void* stream) {
  if (n_plan < 1 || n_plan > kMaxPlan || n_frames < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl = {};
  for (int p = 0; p < n_plan; ++p) {
    const long long* e = plan + 6 * p;
    const long long src = e[0], level_off = e[1], frame_off = e[2], hop = e[3], row = e[4], bank = e[5];
    if ((src != 0 && src != 1) || level_off < 0 || frame_off < 0 || hop < 1 || hop > kMaxHop || row < 0 ||
        bank < 0 || bank >= n_banks)
      return static_cast<int>(cudaErrorInvalidValue);
    pl.src[p] = static_cast<const float*>(src == 0 ? x0 : levels) + level_off + frame_off;
    pl.src_stride[p] = src == 0 ? x0_stride : levels_stride;
    pl.hop[p] = static_cast<int>(hop);
    pl.row[p] = static_cast<int>(row);
    pl.bank[p] = static_cast<int>(bank);
  }
  cudaError_t err = set_up_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((n_frames + kFrames - 1) / kFrames), static_cast<unsigned>(n_plan),
            static_cast<unsigned>(batch));
  octaves_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      pl, n_frames, static_cast<const float*>(banks), static_cast<float*>(out),
      static_cast<int64_t>(out_row_stride), log_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
