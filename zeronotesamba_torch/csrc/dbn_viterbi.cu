// Batched DBN Viterbi forward pass for the beat decoder, one thread block per song.
//
// Replaces: zeronotesamba_tpu/decode/dbn_jax.py, _viterbi_scan under vmap (a
// lax.scan over frames that XLA fuses into one device program; not a Pallas
// kernel). In PyTorch the plain form is a Python loop over frames of about
// six small launches each, so this kernel runs the whole frame loop inside
// one launch.
//
// Function, per song b and frame t, in float32 (the state space of
// decode/dbn.py::_state_space: n_int tempo chains, chain i holding states
// firsts[i] .. lasts[i]):
//   cand[i, j]       = v[lasts[i]] + log_trans[i, j]
//   fc[b, t, j]      = the first i with the largest cand[i, j]      (int16)
//   v_new[s]         = v[s - 1] for a state s that heads no chain,
//   v_new[firsts[j]] = max_i cand[i, j]
//   v_new[s]        += is_beat[s] ? log_act[b, t] : log_nact[b, t]
//   best[b, t]       = the first s with the largest v_new[s]        (int32)
// v starts at v0 in every state; v_final[b] is v after the last frame.
// Every value is one float32 add of two values or a maximum of such values,
// and ties go to the lowest index as in jnp.argmax and torch.argmax, so the
// kernel equals its plain version (ops/cuda/dbn_kernel.py) bit for bit.
//
// Bound on this card: by bytes and operations alike it is microseconds
// (fc's n_int int16 a frame dominates the bytes; about 2 (n_int^2 +
// n_states) adds and compares a frame the operations), but neither binds:
// frame t + 1 needs all of frame t's v, so one song is a serial chain of T
// frames, each two block barriers, a 4-way and a 256-way reduction deep.
// Songs run in parallel on the SMs, so a batch takes about one song's chain.
//
// Design (simple and right first; several songs a block, warp-level
// frames and a shorter chain are later work):
// - 256 threads a song. v is double-buffered in shared memory (2 x n_states
//   floats), beside log_trans (n_int^2 floats), firsts / lasts, and a byte
//   each state for is_beat and for "heads a chain": 33 KB at the default
//   52 chains and 2,210 states.
// - Column maxima: 4 threads a column, each over a quarter of the rows in
//   ascending order; the 4 are lanes 4j .. 4j + 3 of one warp and combine
//   by two shuffles, lower lanes holding lower rows.
// - Argmax over the states: each thread scans its strided states in
//   ascending order, then a shuffle reduction in each warp and one over the
//   8 warps by thread 0, which writes best[b, t].
// - The next frame's two observations are loaded one frame ahead.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 4;  // threads per column of the tempo transition
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) { return v > bv || (v == bv && i < bi); }

__device__ __forceinline__ void combine(float& v, int& i, int lane_mask) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i, lane_mask);
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

size_t smem_bytes(int n_int, int n_states) {
  return sizeof(float) * (2 * static_cast<size_t>(n_states) + static_cast<size_t>(n_int) * n_int) +
         sizeof(int) * 2 * n_int + (sizeof(float) + sizeof(int)) * kWarps + 2 * static_cast<size_t>(n_states);
}

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ log_act, const float* __restrict__ log_nact, int T,
               const float* __restrict__ log_trans, const int* __restrict__ firsts, const int* __restrict__ lasts,
               int n_int, const uint8_t* __restrict__ is_beat, int n_states, float v0, float* __restrict__ v_final,
               int16_t* __restrict__ fc, int* __restrict__ best) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* v_new = v + n_states;
  float* trans = v_new + n_states;  // (n_int, n_int), from-major
  int* s_firsts = reinterpret_cast<int*>(trans + n_int * n_int);
  int* s_lasts = s_firsts + n_int;
  float* warp_v = reinterpret_cast<float*>(s_lasts + n_int);
  int* warp_i = reinterpret_cast<int*>(warp_v + kWarps);
  uint8_t* s_beat = reinterpret_cast<uint8_t*>(warp_i + kWarps);
  uint8_t* s_head = s_beat + n_states;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  for (int k = tid; k < n_int * n_int; k += kThreads) trans[k] = log_trans[k];
  for (int k = tid; k < n_int; k += kThreads) {
    s_firsts[k] = firsts[k];
    s_lasts[k] = lasts[k];
  }
  for (int s = tid; s < n_states; s += kThreads) {
    v[s] = v0;
    s_beat[s] = is_beat[s];
    s_head[s] = 0;
  }
  __syncthreads();
  for (int k = tid; k < n_int; k += kThreads) s_head[s_firsts[k]] = 1;
  __syncthreads();

  const int rows = (n_int + kSplit - 1) / kSplit;
  const int slots = n_int * kSplit;
  const float* la_row = log_act + b * T;
  const float* lna_row = log_nact + b * T;
  int16_t* fc_song = fc + b * T * n_int;
  float la = T > 0 ? la_row[0] : 0.f, lna = T > 0 ? lna_row[0] : 0.f;
  for (int t = 0; t < T; ++t) {
    const float la_next = t + 1 < T ? la_row[t + 1] : 0.f;
    const float lna_next = t + 1 < T ? lna_row[t + 1] : 0.f;
    // Tempo transitions into each chain head. Every thread runs every
    // round, so whole warps take part in the shuffles; a thread without a
    // slot carries (-inf, INT_MAX), which loses to any candidate.
    for (int base = 0; base < slots; base += kThreads) {
      const int slot = base + tid, j = slot / kSplit, q = slot % kSplit;
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (slot < slots) {
        const int i1 = min((q + 1) * rows, n_int);
        for (int i = q * rows; i < i1; ++i) {
          const float c = v[s_lasts[i]] + trans[i * n_int + j];
          if (better(c, i, bv, bi)) {
            bv = c;
            bi = i;
          }
        }
      }
      combine(bv, bi, 1);
      combine(bv, bi, 2);
      if (slot < slots && q == 0) {
        fc_song[static_cast<size_t>(t) * n_int + j] = static_cast<int16_t>(bi);
        const int f = s_firsts[j];
        v_new[f] = bv + (s_beat[f] ? la : lna);
      }
    }
    // Advance within the chains.
    for (int s = tid; s < n_states; s += kThreads)
      if (!s_head[s]) v_new[s] = v[s - 1] + (s_beat[s] ? la : lna);
    __syncthreads();
    // The best state of this frame.
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int s = tid; s < n_states; s += kThreads)
      if (better(v_new[s], s, bv, bi)) {
        bv = v_new[s];
        bi = s;
      }
    for (int m = 16; m > 0; m >>= 1) combine(bv, bi, m);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (better(warp_v[w], warp_i[w], bv, bi)) {
          bv = warp_v[w];
          bi = warp_i[w];
        }
      best[b * T + t] = bi;
    }
    float* swap = v;
    v = v_new;
    v_new = swap;
    la = la_next;
    lna = lna_next;
  }
  for (int s = tid; s < n_states; s += kThreads) v_final[b * n_states + s] = v[s];
}

}  // namespace

extern "C" {

// log_act, log_nact: (batch, T) float32. log_trans: (n_int, n_int) float32,
// from-major. firsts, lasts: (n_int,) int32. is_beat: (n_states,) uint8.
// Outputs: v_final (batch, n_states) float32, fc (batch, T, n_int) int16,
// best (batch, T) int32. All pointers are device memory, contiguous.
// Returns cudaGetLastError() after the launch.
int zns_dbn_viterbi(const void* log_act, const void* log_nact, long long batch, long long T, const void* log_trans,
                    const void* firsts, const void* lasts, int n_int, const void* is_beat, int n_states, float v0,
                    void* v_final, void* fc, void* best, void* stream) {
  const size_t smem = smem_bytes(n_int, n_states);
  if (batch < 1 || batch > INT_MAX || T < 0 || T > INT_MAX || n_int < 1 || n_int > SHRT_MAX || n_states < n_int ||
      smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err =
        cudaFuncSetAttribute(viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_kernel<<<static_cast<unsigned>(batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_act), static_cast<const float*>(log_nact), static_cast<int>(T),
      static_cast<const float*>(log_trans), static_cast<const int*>(firsts), static_cast<const int*>(lasts), n_int,
      static_cast<const uint8_t*>(is_beat), n_states, v0, static_cast<float*>(v_final), static_cast<int16_t*>(fc),
      static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
