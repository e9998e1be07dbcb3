// Spleeter's decoder block on the card: concat, 5x5 stride-2 transposed conv,
// crop, bias, ReLU and the inference BatchNorm in one float32 launch.
//
// Replaces no TPU kernel: the JAX package has no Spleeter. It was added
// because cuDNN runs these transposed convs as 32 x 32 FFT tiles, a complex
// GEMM, an inverse FFT and its data-gradient engine, at about a tenth of the
// card's float32 rate, and the concat, ReLU and BatchNorm as passes of their
// own.
//
// Function, for batch row b, output channel co and output position (y, x) <
// (2 h, 2 w), with in = channels [skip, u] (c_skip + c_u of them, read from
// the two tensors directly; c_skip may be 0):
//     z = bias[co] + sum_{ci, ky, kx} w[ci, co, ky, kx] * in[b, ci, (y + 1 - ky) / 2, (x + 1 - kx) / 2]
// over the taps where both divisions are exact and in range, then
//     out[b, co, y, x] = relu(z) * scale[co] + shift[co],
//     scale = gamma / sqrt(var + eps), shift = beta - mean * scale.
// That is nn.ConvTranspose2d(cin, cout, 5, stride=2, padding=1) with its last
// row and column cropped (models/spleeter.up), then ReLU and BatchNorm2d in
// eval. The weights are read as PyTorch holds them, (cin, cout, 5, 5), and the
// BatchNorm's parameters and running statistics as they are, so nothing is
// folded or re-laid outside the launch and nothing goes stale.
//
// Bound on this card: operations at blocks 1 to 5 of a U-Net (6.25 taps an
// output, 3,200 down to 400 MACs an output over 512 to 64 input channels);
// block 6 (32 channels in, 1 out) is near its bytes. The sums stay in float32
// FFMA: the configuration runs with TF32 off.
//
// Design. A 5x5 stride-2 transposed conv splits into four sub-pixel phases:
// the output (2m + py, 2n + px) takes kernel rows ky = py + 1 - 2 dy for input
// rows m + dy, dy in {-1, 0, 1} (py 0: ky 3, 1; py 1: ky 4, 2, 0), and the
// same along columns. So an input-grid position (m, n) owns a 2 x 2 quad of
// outputs that together read the 3 x 3 inputs around it with each of the 25
// taps once: no zero-stuffing, and no output of the cropped row or column.
// - The grid runs over (output-channel block x column tile, row tile, batch
//   row). A block of 8 warps owns `rows` x `cols` input-grid positions (cols =
//   4 lc) with all four phases, and n_cg x TCO output channels. Warp w is
//   (k-group kg, channel group cg, row group wp): n_kg x n_cg x n_wp = 8. Its
//   32 lanes are lr x lc over the positions; a lane owns PR rows x 4 columns
//   of positions and TCO channels: PR x 4 x 4 x TCO sums in registers.
// - Staging: for `chans` input channels a stage, the block's input tile with
//   a halo ((rows + 2) x len floats from row m0 - 1 and column n0 - 2, two
//   floats a cp.async where the width is even, zero-filled outside the
//   input) and the channel's 25 x (n_cg TCO) weights, laid out [tap][co] on
//   the way (a row of taps padded by 4 floats, so that a warp's copies spread
//   over the banks). Stages go through a ring of `stages` slots, one barrier
//   a stage. Shared loads and these copies share one pipe of the SM, so each
//   instruction of either counts: the copies are as wide as the layouts
//   allow, and a lane's TCO weights of a tap are one vector load.
// - A lane loads its (PR + 2) x 6 inputs of a channel into registers (two
//   float4 loads a row; the row length is padded so that the lanes of a
//   quarter-warp hit distinct banks), then for each of the 25 taps one
//   broadcast load of its TCO weights and PR x 4 x TCO FFMAs: its weights
//   feed its PR x 4 positions, so the instances trade positions (fewer
//   weight loads an FFMA) against sums in registers (fewer warps an SM).
// - The k-groups split each stage's channels: group kg sums channels
//   [kg chans / n_kg, (kg + 1) chans / n_kg) of every stage. Where n_kg > 1
//   (few outputs, many channels: block 1 of a net) the groups' sums meet in
//   shared memory after the last stage and group 0 adds them in group order.
// - Order of sums: each output is its k-groups' FFMA chains (over their
//   channels in order, and within a channel over ky, kx in order), added in
//   group order, then the bias. No atomics: the same input and layout give
//   the same bits on every run, and the wrapper picks the layout from the
//   shape alone.
// - The epilogue adds the bias, applies ReLU and the BatchNorm folded in
//   registers, and writes each output row's 8 outputs of a lane (4 columns,
//   even and odd) as two float4 stores where the row allows.
// - The wrapper (ops/cuda/deconv_kernel.py) picks the layout from the shape.
//   The kernel runs on the caller's stream, allocates nothing and never
//   synchronises, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 25;
constexpr int kCols = 4;  // input-grid columns a lane owns
constexpr int kMaxStages = 4;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may ask for on sm_90
constexpr int kMaxDevices = 64;

struct Shape {
  int c_skip, c_u, h, w, cout;
  float eps;
  int lc, lr, n_wp, n_cg, n_kg, chans, stages;
  int rows, cols, len;  // the block's positions (rows x cols) and a staged row's floats
  int tile_floats, chan_floats, stage_floats, red_floats, n_co;
};

__device__ inline void cp_async4_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async8_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

template <int TCO>
__device__ inline void load_weights(const float* p, float (&wv)[TCO]) {
  if constexpr (TCO == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
  } else if constexpr (TCO == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    wv[0] = a.x; wv[1] = a.y;
  } else {
    static_assert(TCO == 1, "TCO is 4, 2 or 1");
    wv[0] = *p;
  }
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` committed groups are still in flight (0 to kMaxStages - 2).
__device__ inline void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

template <int TCO, int PR>
__global__ void __launch_bounds__(kThreads, TCO * PR >= 8 ? 1 : 2)  // 2 blocks an SM at 64 sums a lane
deconv_fprop_kernel(const float* __restrict__ skip, const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ mean, const float* __restrict__ var, float* __restrict__ y,
                    const Shape s) {
  constexpr int kAcc = PR * kCols * 4 * TCO;  // (row, column, phase, channel)
  extern __shared__ __align__(16) float smem[];

  const int co_block = s.n_cg * TCO;
  const int co0 = (blockIdx.x % s.n_co) * co_block;
  const int n0 = (blockIdx.x / s.n_co) * s.cols;
  const int m0 = blockIdx.y * s.rows;
  const int64_t b = blockIdx.z;
  const int cin = s.c_skip + s.c_u;
  const int64_t plane = static_cast<int64_t>(s.h) * s.w;
  const float* skip_b = skip + b * s.c_skip * plane;
  const float* u_b = u + b * s.c_u * plane;

  // Chunk k (input channels k * chans ...) into ring slot k % stages; channel
  // c of it holds [rows + 2][len] inputs from (m0 - 1, n0 - 2) on, then
  // [25][wstride] weights. A thread stages input pieces (r, piece), (r, piece)
  // + 256 pieces, ... of `span` floats (2 where the width is even, so that
  // every piece is 8-byte aligned in both memories and wholly inside or
  // outside the input, else 1): it steps through the tile without a division
  // per piece.
  const int n_chunks = (cin + s.chans - 1) / s.chans;
  const int span = s.w % 2 == 0 ? 2 : 1;
  const int row_pieces = s.len / span;
  const int tile_pieces = (s.rows + 2) * row_pieces;
  const int w_n = kTaps * co_block;
  const int wstride = co_block + 4;
  const int first_r = threadIdx.x / row_pieces;
  const int first_piece = threadIdx.x - first_r * row_pieces;
  const int step_r = kThreads / row_pieces;
  const int step_piece = kThreads - step_r * row_pieces;
  auto stage = [&](int k) {
    if (k >= n_chunks) return;
    const int c0 = k * s.chans;
    const int nc = min(s.chans, cin - c0);
    float* slot = smem + (k % s.stages) * s.stage_floats;
    for (int c = 0; c < nc; ++c) {
      const int ci = c0 + c;
      const float* src = ci < s.c_skip ? skip_b + ci * plane : u_b + (ci - s.c_skip) * plane;
      float* xs = slot + c * s.chan_floats;
      int r = first_r, piece = first_piece;
      for (int idx = threadIdx.x; idx < tile_pieces; idx += kThreads) {
        const int gm = m0 - 1 + r;
        const int gn = n0 - 2 + piece * span;
        const bool in = gm >= 0 && gm < s.h && gn >= 0 && gn < s.w;
        const float* g = in ? src + static_cast<int64_t>(gm) * s.w + gn : src;
        if (span == 2)
          cp_async8_zfill(xs + 2 * idx, g, in);
        else
          cp_async4_zfill(xs + idx, g, in);
        r += step_r;
        piece += step_piece;
        if (piece >= row_pieces) {
          piece -= row_pieces;
          ++r;
        }
      }
      float* ws = xs + s.tile_floats;
      const float* wc = w + (static_cast<int64_t>(ci) * s.cout + co0) * kTaps;
      for (int idx = threadIdx.x; idx < w_n; idx += kThreads) {
        const int co = idx / kTaps;
        cp_async4(ws + (idx - co * kTaps) * wstride + co, wc + idx);
      }
    }
  };
  for (int k = 0; k < s.stages - 1; ++k) {
    stage(k);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kg = warp % s.n_kg;
  const int cg = (warp / s.n_kg) % s.n_cg;
  const int wp = warp / (s.n_kg * s.n_cg);
  const int lane_r = lane / s.lc;
  const int row0 = (wp * s.lr + lane_r) * PR;  // the lane's first row, from m0
  const int col0 = (lane - lane_r * s.lc) * kCols;  // its first column, from n0 (the tile's column col0 + 2)
  const int per_kg = s.chans / s.n_kg;

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait(s.stages - 2);  // chunk k has landed
    __syncthreads();              // ... for every thread, and chunk k - 1 is summed
    stage(k + s.stages - 1);      // into the slot chunk k - 1 used
    cp_async_commit();            // possibly empty, so that one wait rule holds throughout
    const float* slot = smem + (k % s.stages) * s.stage_floats;
    const int nc = min(s.chans, cin - k * s.chans);
    const int c_end = min((kg + 1) * per_kg, nc);
#pragma unroll 1
    for (int c = kg * per_kg; c < c_end; ++c) {
      const float* xs = slot + c * s.chan_floats + row0 * s.len + col0;
      const float* ws = slot + c * s.chan_floats + s.tile_floats + cg * TCO;
      // Input rows m - 1 .. m + PR, columns n - 2 .. n + 5 (the first and last unused).
      float xv[PR + 2][8];
#pragma unroll
      for (int r = 0; r < PR + 2; ++r) {
        const float4 lo = *reinterpret_cast<const float4*>(xs + r * s.len);
        const float4 hi = *reinterpret_cast<const float4*>(xs + r * s.len + 4);
        xv[r][0] = lo.x; xv[r][1] = lo.y; xv[r][2] = lo.z; xv[r][3] = lo.w;
        xv[r][4] = hi.x; xv[r][5] = hi.y; xv[r][6] = hi.z; xv[r][7] = hi.w;
      }
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        const int py = (ky + 1) & 1;
        const int dr = (4 - ky) / 2;  // input row m + dr - 1
#pragma unroll
        for (int kx = 0; kx < 5; ++kx) {
          const int px = (kx + 1) & 1;
          const int dc = (4 - kx) / 2 + 1;  // input column n + dc - 2
          float wv[TCO];
          load_weights<TCO>(ws + (ky * 5 + kx) * wstride, wv);
#pragma unroll
          for (int a = 0; a < PR; ++a)
#pragma unroll
            for (int q = 0; q < kCols; ++q)
#pragma unroll
              for (int i = 0; i < TCO; ++i) {
                float& sum = acc[((a * kCols + q) * 4 + py * 2 + px) * TCO + i];
                sum = fmaf(wv[i], xv[a + dr][q + dc], sum);
              }
        }
      }
    }
  }
  cp_async_wait(0);

  if (s.n_kg > 1) {
    // The k-groups' sums meet in shared memory (the ring is done with).
    __syncthreads();
    const int tile = cg + s.n_cg * wp;
    const int tiles = s.n_cg * s.n_wp;
    if (kg > 0) {
      float* dst = smem + ((kg - 1) * tiles + tile) * kAcc * 32 + lane;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) dst[j * 32] = acc[j];
    }
    __syncthreads();
    if (kg > 0) return;
    for (int g = 1; g < s.n_kg; ++g) {
      const float* src = smem + ((g - 1) * tiles + tile) * kAcc * 32 + lane;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] += src[j * 32];
    }
  }

  const int n = n0 + col0;
  const bool vec = s.w % 2 == 0 && n + kCols <= s.w;
  const int64_t out_w = 2 * static_cast<int64_t>(s.w);
#pragma unroll
  for (int i = 0; i < TCO; ++i) {
    const int co = co0 + cg * TCO + i;
    const float scale = __ldg(gamma + co) / sqrtf(__ldg(var + co) + s.eps);
    const float shift = __ldg(beta + co) - __ldg(mean + co) * scale;
    const float bv = __ldg(bias + co);
    float* yc = y + (b * s.cout + co) * 4 * plane;
#pragma unroll
    for (int a = 0; a < PR; ++a) {
      const int m = m0 + row0 + a;
      if (m >= s.h) continue;
#pragma unroll
      for (int py = 0; py < 2; ++py) {
        float v[2 * kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q)
#pragma unroll
          for (int px = 0; px < 2; ++px)
            v[2 * q + px] = fmaxf(acc[((a * kCols + q) * 4 + py * 2 + px) * TCO + i] + bv, 0.0f) * scale + shift;
        float* yr = yc + (2 * m + py) * out_w + 2 * n;
        if (vec) {
          reinterpret_cast<float4*>(yr)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(yr)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int j = 0; j < 2 * kCols; ++j)
            if (n + j / 2 < s.w) yr[j] = v[j];
        }
      }
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, float*, const Shape);

// The instances (TCO, PR): 64 sums a lane at (4, 1), (2, 2), (1, 4); 128 at (4, 2), (2, 4), (1, 8).
constexpr int kInstances = 6;
KernelFn kernel_for(int tco, int pr) {
  if (tco == 4 && pr == 1) return deconv_fprop_kernel<4, 1>;
  if (tco == 4 && pr == 2) return deconv_fprop_kernel<4, 2>;
  if (tco == 2 && pr == 2) return deconv_fprop_kernel<2, 2>;
  if (tco == 2 && pr == 4) return deconv_fprop_kernel<2, 4>;
  if (tco == 1 && pr == 4) return deconv_fprop_kernel<1, 4>;
  if (tco == 1 && pr == 8) return deconv_fprop_kernel<1, 8>;
  return nullptr;
}

int instance(int tco, int pr) { return (tco == 4 ? 0 : tco == 2 ? 2 : 4) + (tco * pr == 8 ? 1 : 0); }

// Raise a kernel's dynamic shared-memory limit, once per kernel, device and process.
cudaError_t set_up_once(KernelFn fn, int tco, int pr) {
  static bool ready[kMaxDevices][kInstances] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  bool& done = ready[dev][instance(tco, pr)];
  if (done) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done = true;
  return err;
}

// Floats a staged input row holds: the block's columns, the halo and the two
// unused floats of the last lane's second float4, rounded up to float4s; where
// a quarter-warp spans two lane rows (lc 4), padded so that they hit distinct
// banks (their rows pr * len floats apart, 16 banks apart), which no multiple
// of 4 gives at 8 rows a lane.
int row_len(int lc, int pr) {
  int len = lc * kCols + 4;
  if (lc == 4 && pr < 8)
    while ((pr * len) % 32 != 16) len += 4;
  return len;
}

// The block's layout for a shape; false where the kernel does not take it.
bool make_shape(int c_skip, int c_u, int h, int w, int cout, int tco, int pr, int lc, int n_wp, int n_cg, int n_kg,
                int chans, int stages, Shape* s) {
  if (kernel_for(tco, pr) == nullptr || c_skip < 0 || c_u < 1 || h < 1 || w < 1 || cout < 1 ||
      (lc != 4 && lc != 8) || n_wp < 1 || n_cg < 1 || n_kg < 1 || n_wp * n_cg * n_kg != kWarps ||
      cout % (n_cg * tco) != 0 || chans < 1 || chans > 16 || chans % n_kg != 0 || stages < 2 ||
      stages > kMaxStages)
    return false;
  s->c_skip = c_skip; s->c_u = c_u; s->h = h; s->w = w; s->cout = cout;
  s->lc = lc; s->lr = 32 / lc; s->n_wp = n_wp; s->n_cg = n_cg; s->n_kg = n_kg; s->chans = chans; s->stages = stages;
  s->rows = n_wp * s->lr * pr;
  s->cols = lc * kCols;
  s->len = row_len(lc, pr);
  s->tile_floats = (s->rows + 2) * s->len;  // a multiple of 4: the weights start 16-byte aligned
  s->chan_floats = s->tile_floats + kTaps * (n_cg * tco + 4);
  if (s->chan_floats % 4 != 0) s->chan_floats += 4 - s->chan_floats % 4;  // 16-byte aligned channels
  s->stage_floats = chans * s->chan_floats;
  s->red_floats = n_kg > 1 ? (n_kg - 1) * n_cg * n_wp * 32 * (pr * kCols * 4 * tco) : 0;
  s->n_co = cout / (n_cg * tco);
  const int64_t floats = static_cast<int64_t>(stages) * s->stage_floats;
  return (floats > s->red_floats ? floats : s->red_floats) * 4 <= kMaxSmemBytes;
}

int smem_bytes(const Shape& s) {
  const int ring = s.stages * s.stage_floats;
  return 4 * (ring > s.red_floats ? ring : s.red_floats);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of the layout for a shape, into smem; returns
// 0, or cudaErrorInvalidValue for a layout the kernel does not take. No card needed.
int zns_deconv_smem(int c_skip, int c_u, int h, int w, int cout, int tco, int pr, int lc, int n_wp, int n_cg,
                    int n_kg, int chans, int stages, int* smem) {
  Shape s;
  if (!make_shape(c_skip, c_u, h, w, cout, tco, pr, lc, n_wp, n_cg, n_kg, chans, stages, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(s);
  return 0;
}

// Resident blocks per SM of instance (tco, pr) at smem_bytes of dynamic shared memory.
int zns_deconv_occupancy(int tco, int pr, int smem, int* blocks) {
  KernelFn fn = kernel_for(tco, pr);
  if (fn == nullptr || smem < 0 || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_up_once(fn, tco, pr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem));
}

// skip: (batch, c_skip, h, w), u: (batch, c_u, h, w), float32 contiguous (skip
// unread where c_skip is 0); w: (c_skip + c_u, cout, 5, 5) float32 contiguous;
// bias, gamma, beta, mean, var: (cout,); y: (batch, cout, 2 h, 2 w) float32
// contiguous, 16-byte aligned. Launches on `stream`; returns cudaGetLastError()
// after the launch.
int zns_deconv_fprop(const void* skip, const void* u, const void* w, const void* bias, const void* gamma,
                     const void* beta, const void* mean, const void* var, float eps, void* y, int batch, int c_skip,
                     int c_u, int h, int wd, int cout, int tco, int pr, int lc, int n_wp, int n_cg, int n_kg,
                     int chans, int stages, void* stream) {
  Shape s;
  if (batch < 1 || batch > 65535 ||
      !make_shape(c_skip, c_u, h, wd, cout, tco, pr, lc, n_wp, n_cg, n_kg, chans, stages, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  s.eps = eps;
  KernelFn fn = kernel_for(tco, pr);
  cudaError_t err = set_up_once(fn, tco, pr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t col_tiles = (wd + s.cols - 1) / s.cols;
  const int64_t row_tiles = (h + s.rows - 1) / s.rows;
  if (col_tiles * s.n_co > 2147483647LL || row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(col_tiles * s.n_co), static_cast<unsigned>(row_tiles),
            static_cast<unsigned>(batch));
  fn<<<grid, kThreads, smem_bytes(s), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(skip), static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(var), static_cast<float*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
