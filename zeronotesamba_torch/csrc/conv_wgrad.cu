// Weight and bias gradients of the encoders' float32 convolutions: stride 1, zero padding, NCHW.
//
// Replaces no TPU kernel: the JAX package leaves these convs and their
// gradients to XLA (zeronotesamba_tpu/models/encoder.py). It was added
// because cuDNN's float32 weight gradient at the encoders' shapes
// (wgrad_alg0_engine and the indexed implicit GEMM) reaches under two fifths
// of the card's float32 rate, about half of every fine-tune step.
//
// Function, for output channel co, input channel ci, row tap dy and tap dx along time:
//     gw[co, ci, dy, dx] = sum_{b, h, t} gy[b, co, h, t] * x[b, ci, h + dy - ph, t + dx - pw]
//     gb[co] = sum_{b, h, t} gy[b, co, h, t]
// over batch rows b, output rows h < h_out and frames t < w_out, with x read
// as zero outside its (h, w) extent.
//
// Bound on this card: operations. A weight gradient is a GEMM with a short M
// (Cout, 64 to 256), a mid N (Cin kh kw) and a long K (batch h_out w_out: 1.47 M
// for conv 1 at 8 x 1,920): as many FLOPs as the forward, about 2,000 a byte
// for convs 2 to 6. The sums stay in float32 FFMA: the configuration runs
// with TF32 off.
//
// Design. A column is one (ci, dy) row of taps and a group of DX consecutive
// taps dx along it (DX from 9 to 16, whichever pads kw least: kw itself up
// to 15, two groups above). A block of 8 warps owns 64 output channels x 16
// columns; lane l of a warp owns output channels co0 + 16 i + (l % 16), i <
// 4, and column l / 16 of the warp's 2, so a thread keeps 4 x DX sums in
// registers. The grid runs over (column block x channel block, split);
// split s sums chunks [s c, (s + 1) c) of K, a chunk being 64 frames of one
// (batch row, output row).
// - Staging: a chunk's gy tile (64 channels x 64 frames, zero past cout and
//   w_out) and, for each (ci, dy) the block's columns touch, the input row
//   h + dy - ph from frame t0 - pw on (64 + groups DX - 1 floats, zero-filled
//   outside the input), by cp.async through a ring of 3 stages, one barrier
//   a chunk.
// - Sums: for each run of 8 frames a lane loads its column's 8 + DX - 1
//   inputs into registers once; then for each of its 4 channels it loads 8
//   gy values (two float4 loads that 2 lanes share) and does 8 DX FFMAs:
//   each staged input serves 4 channels, each gy value DX taps. (Of 8
//   channels x 6 to 8 taps a thread and 4 x 9 to 16, the second read half
//   the gy floats a FFMA from shared memory and pads kw less: one stream's 8
//   weight gradients at 8 x 1,920 took 154.9 against 164.3 ms; NVIDIA H100
//   80GB HBM3.)
// - Banks: the gy tile's rows are 68 floats apart, so the 16 channel
//   groups' float4 loads fill the banks twice, the least for 256 bytes; the
//   input rows are padded so that a warp's 2 columns read distinct banks
//   (row_len).
// - Bias: the blocks of column block 0 also sum the gy tile, 16 frames a
//   thread, into 4 partial sums a (split, channel).
// - Order of sums: each partial is one thread's FFMA chain over the split's
//   chunks and frames in order, from zero; a second kernel adds the splits'
//   partials in split order. No atomics: the same input gives the same bits
//   on every run. The wrapper picks the split from the shape alone
//   (ops/cuda/conv_kernel.py, plan_wgrad) and allocates the partials; both
//   kernels run on the caller's stream and never synchronise, so a CUDA
//   graph can capture them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCoBlock = 64;                      // output channels a block owns
constexpr int kCoThread = 4;                      // output channels a thread owns
constexpr int kCoGroups = kCoBlock / kCoThread;   // lanes of a warp along output channels
constexpr int kColsWarp = 32 / kCoGroups;         // columns a warp owns
constexpr int kCols = kWarps * kColsWarp;         // columns a block owns
constexpr int kFrames = 64;                       // frames a chunk holds
constexpr int kSub = 8;                           // frames summed between loads of a lane's inputs
constexpr int kStages = 3;
constexpr int kGyStride = kFrames + 4;            // 4 (mod 32): see Banks above
constexpr int kBiasParts = kThreads / kCoBlock;   // partial bias sums a (split, channel)
constexpr int kMaxSmemBytes = 232448;             // 227 KB, the most a block may ask for on sm_90
constexpr int kMaxDevices = 64;
constexpr int kMaxSplits = 65535;

// Taps along time a column holds: of 16 down to 9, the one that pads kw least (ties to more).
__host__ __device__ constexpr int dx_tile(int kw) {
  int best = 16;
  for (int d = 15; d >= 9; --d)
    if ((kw + d - 1) / d * d < (kw + best - 1) / best * best) best = d;
  return best;
}

struct Shape {
  int cin, h, w, cout, kh, ph, pw, h_out, w_out;
  int dx, groups, ncol, col_blocks, co_blocks, t_tiles;
  int x_len, row_len, max_pairs, stage_floats, splits, gy_vec;
  int64_t chunks, chunks_per_split;
};

__device__ inline void cp_async4_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async16_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most kStages - 2 committed groups are still in flight.
__device__ inline void cp_async_wait_ring() {
  static_assert(kStages == 3, "the wait below keeps kStages - 2 groups in flight");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gy, float* __restrict__ part,
                  float* __restrict__ bias_part, const Shape s) {
  constexpr int DX = dx_tile(KW);
  constexpr int kXW = kSub + DX - 1;  // inputs a lane holds for one run of kSub frames
  extern __shared__ __align__(16) float smem[];

  const int col_blk = blockIdx.x % s.col_blocks;
  const int co0 = (blockIdx.x / s.col_blocks) * kCoBlock;
  const int c0 = col_blk * kCols;
  const int p0 = c0 / s.groups;  // the first (ci, dy) row the block stages
  const int n_pairs = min((c0 + kCols - 1) / s.groups, s.cin * s.kh - 1) - p0 + 1;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.y) * s.chunks_per_split;
  const int n_chunks = static_cast<int>(min(s.chunks_per_split, s.chunks - k_begin));
  const int64_t plane = static_cast<int64_t>(s.h) * s.w;
  const int64_t gy_plane = static_cast<int64_t>(s.h_out) * s.w_out;
  const int len = s.x_len;

  // A thread stages input floats (q, col), (q, col) + 256, ... of the
  // block's n_pairs x len rows: it steps through them by (step_q, step_col),
  // and through the rows' (ci, dy) alongside, without a division per element.
  const int first_q = threadIdx.x / len;
  const int first_col = threadIdx.x - first_q * len;
  const int step_q = kThreads / len;
  const int step_col = kThreads - step_q * len;
  const int first_ci = (p0 + first_q) / s.kh;
  const int first_dy = p0 + first_q - first_ci * s.kh;

  auto stage = [&](int k) {
    if (k >= n_chunks) return;
    const int64_t kk = k_begin + k;
    const int tt = static_cast<int>(kk % s.t_tiles);
    const int64_t r = kk / s.t_tiles;
    const int h = static_cast<int>(r % s.h_out);
    const int64_t b = r / s.h_out;
    const int t0 = tt * kFrames;
    float* slot = smem + (k % kStages) * s.stage_floats;
    const float* gyr = gy + (b * s.cout) * gy_plane + static_cast<int64_t>(h) * s.w_out + t0;
    if (s.gy_vec) {  // w_out % 4 == 0 and gy 16-byte aligned: a float4 lies wholly inside or outside
      for (int idx = threadIdx.x; idx < kCoBlock * kFrames / 4; idx += kThreads) {
        const int row = idx / (kFrames / 4);
        const int c = 4 * (idx % (kFrames / 4));
        const bool in = co0 + row < s.cout && t0 + c < s.w_out;
        cp_async16_zfill(slot + row * kGyStride + c, in ? gyr + (co0 + row) * gy_plane + c : gy, in);
      }
    } else {
      for (int idx = threadIdx.x; idx < kCoBlock * kFrames; idx += kThreads) {
        const int row = idx / kFrames;
        const int c = idx % kFrames;
        const bool in = co0 + row < s.cout && t0 + c < s.w_out;
        cp_async4_zfill(slot + row * kGyStride + c, in ? gyr + (co0 + row) * gy_plane + c : gy, in);
      }
    }
    float* xs = slot + kCoBlock * kGyStride;
    const float* xb = x + b * s.cin * plane;
    int q = first_q, col = first_col, ci = first_ci, dy = first_dy;
    for (int idx = threadIdx.x; idx < n_pairs * len; idx += kThreads) {
      const int gh = h + dy - s.ph;
      const int gt = t0 - s.pw + col;
      const bool in = gh >= 0 && gh < s.h && gt >= 0 && gt < s.w;
      cp_async4_zfill(xs + q * s.row_len + col, in ? xb + ci * plane + static_cast<int64_t>(gh) * s.w + gt : x, in);
      int dq = step_q;
      col += step_col;
      if (col >= len) {
        col -= len;
        ++dq;
      }
      q += dq;
      dy += dq;
      while (dy >= s.kh) {
        dy -= s.kh;
        ++ci;
      }
    }
  };
  for (int k = 0; k < kStages - 1; ++k) {
    stage(k);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = lane % kCoGroups;
  const int col = c0 + warp * kColsWarp + lane / kCoGroups;
  const bool active = c0 + warp * kColsWarp < s.ncol;  // warp-uniform
  const int pair = min(col, s.ncol - 1) / s.groups;
  const int g = min(col, s.ncol - 1) - pair * s.groups;
  const int x_off = kCoBlock * kGyStride + (pair - p0) * s.row_len + g * DX;
  const bool bias_block = bias_part != nullptr && col_blk == 0;

  float acc[kCoThread][DX];
#pragma unroll
  for (int i = 0; i < kCoThread; ++i)
#pragma unroll
    for (int d = 0; d < DX; ++d) acc[i][d] = 0.0f;
  float bsum = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait_ring();  // chunk k has landed
    __syncthreads();       // ... for every thread, and chunk k - 1 is summed
    stage(k + kStages - 1);  // into the slot chunk k - 1 used
    cp_async_commit();       // possibly empty, so that one wait rule holds throughout
    const float* slot = smem + (k % kStages) * s.stage_floats;
    if (bias_block) {
      const float4* gb = reinterpret_cast<const float4*>(slot + (threadIdx.x / kBiasParts) * kGyStride +
                                                         (threadIdx.x % kBiasParts) * (kFrames / kBiasParts));
#pragma unroll
      for (int v = 0; v < kFrames / kBiasParts / 4; ++v) {
        const float4 a = gb[v];
        bsum += a.x;
        bsum += a.y;
        bsum += a.z;
        bsum += a.w;
      }
    }
    if (!active) continue;
    const float* xr = slot + x_off;
    const float* gr = slot + cg * kGyStride;
#pragma unroll 1
    for (int t = 0; t < kFrames; t += kSub) {
      float xv[kXW];
#pragma unroll
      for (int q = 0; q < kXW; ++q) xv[q] = xr[t + q];
#pragma unroll
      for (int i = 0; i < kCoThread; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(gr + i * kCoGroups * kGyStride + t);
        const float4 c = *reinterpret_cast<const float4*>(gr + i * kCoGroups * kGyStride + t + 4);
        const float gv[kSub] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int d = 0; d < DX; ++d) acc[i][d] = fmaf(gv[j], xv[j + d], acc[i][d]);
      }
    }
  }

  if (bias_block && co0 + static_cast<int>(threadIdx.x) / kBiasParts < s.cout)
    bias_part[(static_cast<int64_t>(blockIdx.y) * s.cout + co0 + threadIdx.x / kBiasParts) * kBiasParts +
              threadIdx.x % kBiasParts] = bsum;
  if (!active || col >= s.ncol) return;
#pragma unroll
  for (int i = 0; i < kCoThread; ++i) {
    const int co = co0 + i * kCoGroups + cg;
    if (co >= s.cout) continue;
    float* dst = part + ((static_cast<int64_t>(blockIdx.y) * s.cout + co) * s.ncol + col) * DX;
#pragma unroll
    for (int d = 0; d < DX; ++d) dst[d] = acc[i][d];
  }
}

// gw and gb from the splits' partials, each the sum over splits in split order.
__global__ void conv_wgrad_reduce(const float* __restrict__ part, const float* __restrict__ bias_part,
                                  float* __restrict__ gw, float* __restrict__ gb, const Shape s, int kw) {
  const int64_t n_w = static_cast<int64_t>(s.cout) * s.cin * s.kh * kw;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n_w) {
    const int tap = static_cast<int>(e % kw);
    int64_t r = e / kw;
    const int dy = static_cast<int>(r % s.kh);
    r /= s.kh;
    const int ci = static_cast<int>(r % s.cin);
    const int64_t co = r / s.cin;
    const int g = tap / s.dx;
    const int64_t col = (static_cast<int64_t>(ci) * s.kh + dy) * s.groups + g;
    const int64_t stride = static_cast<int64_t>(s.cout) * s.ncol * s.dx;
    const float* p = part + (co * s.ncol + col) * s.dx + (tap - g * s.dx);
    float sum = 0.0f;
    for (int sp = 0; sp < s.splits; ++sp) sum += p[sp * stride];
    gw[e] = sum;
  } else if (gb != nullptr && e < n_w + s.cout) {
    const int co = static_cast<int>(e - n_w);
    float sum = 0.0f;
    for (int sp = 0; sp < s.splits; ++sp)
      for (int q = 0; q < kBiasParts; ++q) sum += bias_part[(static_cast<int64_t>(sp) * s.cout + co) * kBiasParts + q];
    gb[co] = sum;
  }
}

using KernelFn = void (*)(const float*, const float*, float*, float*, const Shape);

KernelFn kernel_for(int kw) {
  switch (kw) {
    case 11: return conv_wgrad_kernel<11>;
    case 13: return conv_wgrad_kernel<13>;
    case 15: return conv_wgrad_kernel<15>;
    case 17: return conv_wgrad_kernel<17>;
    case 19: return conv_wgrad_kernel<19>;
    case 21: return conv_wgrad_kernel<21>;
    case 23: return conv_wgrad_kernel<23>;
    case 25: return conv_wgrad_kernel<25>;
    default: return nullptr;
  }
}

// Raise a kernel's dynamic shared-memory limit, once per kernel, device and process.
cudaError_t set_up_once(KernelFn fn, int kw) {
  static bool ready[kMaxDevices][13] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  bool& done = ready[dev][kw / 2];
  if (done) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done = true;
  return err;
}

// The least staged row length, from `need` floats up, at which a warp's
// kColsWarp consecutive columns, whatever the group of the first, read
// distinct banks (their offsets are pair * row_len + group * dx).
int row_len(int need, int dx, int groups) {
  for (int len = need;; ++len) {
    bool ok = true;
    for (int first = 0; first < groups && ok; ++first)
      for (int a = 0; a < kColsWarp && ok; ++a)
        for (int b = 0; b < a && ok; ++b) {
          const int ca = first + a, cb = first + b;
          ok = ((ca / groups) * len + (ca % groups) * dx) % 32 != ((cb / groups) * len + (cb % groups) * dx) % 32;
        }
    if (ok) return len;
  }
}

// The layout for a shape and a split; false where the kernel does not take it.
bool make_shape(int batch, int cin, int h, int w, int cout, int kh, int kw, int ph, int pw,
                int64_t chunks_per_split, Shape* s) {
  if (kernel_for(kw) == nullptr || batch < 1 || cin < 1 || h < 1 || w < 1 || cout < 1 || kh < 1 || ph < 0 ||
      pw < 0 || chunks_per_split < 1)
    return false;
  s->cin = cin; s->h = h; s->w = w; s->cout = cout; s->kh = kh; s->ph = ph; s->pw = pw;
  s->h_out = h + 2 * ph - kh + 1;
  s->w_out = w + 2 * pw - kw + 1;
  if (s->h_out < 1 || s->w_out < 1) return false;
  s->dx = dx_tile(kw);
  s->groups = (kw + s->dx - 1) / s->dx;
  const int64_t ncol = static_cast<int64_t>(cin) * kh * s->groups;
  if (ncol > (1 << 26)) return false;
  s->ncol = static_cast<int>(ncol);
  s->col_blocks = (s->ncol + kCols - 1) / kCols;
  s->co_blocks = (cout + kCoBlock - 1) / kCoBlock;
  s->t_tiles = (s->w_out + kFrames - 1) / kFrames;
  s->chunks = static_cast<int64_t>(batch) * s->h_out * s->t_tiles;
  s->chunks_per_split = chunks_per_split;
  const int64_t splits = (s->chunks + chunks_per_split - 1) / chunks_per_split;
  if (splits > kMaxSplits || static_cast<int64_t>(s->col_blocks) * s->co_blocks > 2147483647LL) return false;
  s->splits = static_cast<int>(splits);
  s->x_len = kFrames + s->groups * s->dx - 1;  // the last column's last run of frames ends here
  s->row_len = row_len(s->x_len, s->dx, s->groups);
  s->max_pairs = (s->groups - 1 + kCols - 1) / s->groups + 1;
  s->stage_floats = (kCoBlock * kGyStride + s->max_pairs * s->row_len + 3) / 4 * 4;
  s->gy_vec = 0;
  return static_cast<int64_t>(kStages) * s->stage_floats * 4 <= kMaxSmemBytes;
}

}  // namespace

extern "C" {

// The layout the wrapper plans a shape's split with (ops/cuda/conv_kernel.py,
// plan_wgrad), into out[6]: the sum's chunks, blocks a split, weight and bias
// partial sums a split (floats), frames a chunk, and the frames of a chunk
// that each bias partial sums. Returns cudaErrorInvalidValue for a shape the
// kernel does not take.
int zns_wgrad_layout(int batch, int cin, int h, int w, int cout, int kh, int kw, int ph, int pw, long long* out) {
  Shape s;
  if (batch > 65535 || !make_shape(batch, cin, h, w, cout, kh, kw, ph, pw, int64_t{1} << 40, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = s.chunks;
  out[1] = static_cast<int64_t>(s.col_blocks) * s.co_blocks;
  out[2] = static_cast<int64_t>(cout) * s.ncol * s.dx;
  out[3] = static_cast<int64_t>(cout) * kBiasParts;
  out[4] = kFrames;
  out[5] = kFrames / kBiasParts;
  return 0;
}

// Dynamic shared memory (bytes) and resident blocks per SM of the weight
// gradient kernel for kernel width kw, into smem_bytes and blocks. Returns a
// CUDA error code, or cudaErrorInvalidValue for a width it does not take.
int zns_wgrad_occupancy(int kw, int* smem_bytes, int* blocks) {
  Shape s;
  if (!make_shape(1, 1, 1, kw, 1, 1, kw, 0, 0, 1, &s)) return static_cast<int>(cudaErrorInvalidValue);
  KernelFn fn = kernel_for(kw);
  cudaError_t err = set_up_once(fn, kw);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = kStages * s.stage_floats * 4;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, *smem_bytes));
}

// x: (batch, cin, h, w) float32 contiguous; gy: (batch, cout, h_out, w_out)
// float32 contiguous, h_out = h + 2 ph - kh + 1 and w_out = w + 2 pw - kw + 1;
// gw: (cout, cin, kh, kw) float32 contiguous; gb: (cout,) or null. part:
// part_floats floats, which must be splits * cout * ncol * dx for the split
// of chunks_per_split chunks; bias_part: splits * cout * 4 floats, null
// where gb is (zns_wgrad_layout gives both sizes a split). kw is one of 11,
// 13, ..., 25. Launches both kernels on `stream`; returns cudaGetLastError()
// after the launches.
int zns_conv_wgrad(const void* x, const void* gy, void* part, void* bias_part, void* gw, void* gb, int batch,
                   int cin, int h, int w, int cout, int kh, int kw, int ph, int pw, long long chunks_per_split,
                   long long part_floats, void* stream) {
  Shape s;
  if (batch > 65535 || (gb == nullptr) != (bias_part == nullptr) ||
      !make_shape(batch, cin, h, w, cout, kh, kw, ph, pw, chunks_per_split, &s) ||
      part_floats != static_cast<int64_t>(s.splits) * cout * s.ncol * s.dx)
    return static_cast<int>(cudaErrorInvalidValue);
  s.gy_vec = s.w_out % 4 == 0 && reinterpret_cast<uintptr_t>(gy) % 16 == 0;
  KernelFn fn = kernel_for(kw);
  cudaError_t err = set_up_once(fn, kw);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(s.col_blocks * s.co_blocks), static_cast<unsigned>(s.splits));
  fn<<<grid, kThreads, kStages * s.stage_floats * 4, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(gy), static_cast<float*>(part),
      static_cast<float*>(bias_part), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(cout) * cin * kh * kw + (gb == nullptr ? 0 : cout);
  conv_wgrad_reduce<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(bias_part), static_cast<float*>(gw),
      static_cast<float*>(gb), s, kw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
