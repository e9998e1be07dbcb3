// Batched DBN Viterbi forward pass for the beat decoder, one thread block per song.
//
// Replaces: zeronotesamba_tpu/decode/dbn_jax.py, _viterbi_scan under vmap (a
// lax.scan over frames that XLA fuses into one device program; not a Pallas
// kernel). In PyTorch the plain form is a Python loop over frames of about
// six small launches each, so this kernel runs the whole frame loop inside
// one launch.
//
// Function, per song b and frame t, in the score type S (the state space of
// decode/dbn.py::_state_space: n_int tempo chains, chain i holding states
// firsts[i] .. lasts[i], L_i of them):
//   cand[i, j]       = v[lasts[i]] + log_trans[i, j]
//   fc[b, t, j]      = the first i with the largest cand[i, j]      (int16)
//   v_new[s]         = v[s - 1] for a state s that heads no chain,
//   v_new[firsts[j]] = max_i cand[i, j]
//   v_new[s]        += is_beat[s] ? log_act[b, t] : log_nact[b, t]
//   best[b, t]       = the first s with the largest v_new[s]        (int32)
// v starts at v0 in every state; v_final[b] is v after the last frame.
// S is float (zns_dbn_viterbi, dbn_viterbi.cu: the JAX scan's float32, for
// batches of songs) or double (zns_dbn_viterbi_f64, dbn_viterbi_f64.cu: the
// host C++ DBN of dbn_viterbi.cpp, for track_signal's one song on a card).
// Only the scores, observations and maxima take S; fc stays int16, and the
// schedule is the same. Each instance has a source of its own, so the two
// compile in parallel (ops/cuda/build.py).
//
// What bounds it on this card: not bytes or operations (fc's n_int int16 a
// frame dominates the bytes; about 2 (n_int^2 + n_states) adds and compares
// a frame the operations; both are microseconds). Frame t needs frame
// t - 1's values, so a song is a serial chain, run by one block on one SM:
// the chain's length in block barriers and the latency of one block's
// instructions between them bind. At 20 songs most SMs idle and a batch
// takes about one song's chain; at 1,000 songs the blocks fill the card.
//
// Design: rounds of R frames, three block barriers a round (the frame loop
// it replaces had two a frame).
// - The chain shift v_new[s] = v[s - 1] + obs moves a value along a
//   diagonal of (state, frame). Frame t reads v[lasts[i]], a value that
//   entered chain i's head at frame t - L_i. With R <= min_i L_i (the
//   wrapper's frames_per_round: 17 for the default space, whose shortest
//   chain is round(60 * 62.5 / 215) = 17 frames), the R frames of a round
//   read only diagonals that exist at the round's start. A round runs:
//   A. the diagonals at positions p < L - R walk all R frames, one add a
//      frame; the one at position L - 1 - r walks r frames to the chain's
//      last state, where frame r of the round reads it (tail[r][i]);
//   B. after a barrier: the R x n_int tempo maxima, a few frames of a
//      column a thread (2 in a block of 512 threads, up to 5 in one of 256:
//      independent compares to overlap), each over its column's band of
//      finite log_trans rows (the
//      wrapper's transition_bands: half of the default space's 2,704
//      entries are -inf, and such a candidate is never the first maximum
//      unless every candidate is -inf, when the choice is row 0); heads and
//      fc staged in shared memory; the previous round's best states;
//   C. after a barrier: the diagonal born at frame r of chain i takes its
//      head value and walks to the round's end; fc goes out as one
//      contiguous run of R x n_int int16; a barrier.
// - Each chain is a ring of slots in shared memory, the diagonal at
//   position p living in slot (L - 1 - p + frames done) mod L, so a
//   diagonal keeps its slot, a new one takes the slot of the one whose tail
//   was read, and no value moves. The work is listed by position (the
//   lasting positions in a table, the last R positions of every chain r by
//   r, each r on whole warps so a warp's lanes walk alike), so a thread
//   walks its diagonals without branching apart from its warp.
// - Argmax off the chain: each thread keeps R running (value, state) first
//   maxima in registers, one a frame of the round, and stores them as
//   (value, state) pairs at the round's end; in the next round's phase B
//   the last warps (those with the least tempo work) reduce them and write
//   best. There is no per-frame barrier and no thread-0 loop. A thread
//   meets its lasting diagonals that pass no beat state first and in state
//   order, so for them a strict > keeps the first maximum; all others use
//   the (value, index) comparison.
// - The frames of a full round run unrolled with no test between them, so
//   the compiler can overlap one frame's add with the previous frame's
//   compare; a new diagonal enters the unrolled frames at its birth frame.
// - One song a block, 256 threads, or 512 where the batch leaves SMs idle
//   (the wrapper's choice, by chip_smoke.py's sweep of 64 to 512 threads:
//   512 is faster for 1 and 20 songs, 256 for 1,000). Several songs a block
//   would shorten no chain: at 20 songs the SMs that idle would idle the
//   same, and at 1,000 songs the blocks already fill the card.
// What holds it back (PERF.md): a round's phases are each a few thousand
// cycles of one block's dependent instructions, with one block an SM at
// small batches; more threads a song help phases A and C but not B (its
// units are the R x n_int column-frames), and R cannot pass the shortest
// chain's length.
//
// Exactness: every value is made by the plain loop's own adds in S, in
// its order (a diagonal's value at frame t is its value at frame t - 1 plus
// frame t's observation; a head is the column maximum plus its
// observation); only the schedule changes. The work is adds, maxima and
// compares (no multiply, so nvcc contracts nothing into an FMA, and the
// build uses no fast-math flag), and ties go to the lowest index as in
// torch.argmax, so the kernel equals its plain version
// (ops/cuda/dbn_kernel.py) bit for bit. tests/test_torch_viterbi_rounds.py
// holds this schedule, written out in numpy, to the plain loop on the CPU.
// The host C++ runs the same recursion in double: a strict > first maximum
// over every row (an out-of-band row's candidate is -inf, never taken), the
// same adds with SSE2 on x86-64 and no fast-math; so the double instance's
// fc and best reproduce its tempo choices and final state bit for bit.
// Double: 3 x 17 scores a thread in registers (la, lna, the running maxima)
// take twice the registers, so its block is at most 384 threads (up to 170
// registers a thread; 163 at R = 17, no spill), and a (value, state) pair
// takes 16 bytes.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// The score type's (value, state) pair, the state's int bits in a value's
// place, and a block's largest size.
template <typename S>
struct Score;
template <>
struct Score<float> {
  using Pair = float2;
  static constexpr int kMaxThreads = 512;
  __device__ static Pair pair(float v, int i) { return make_float2(v, __int_as_float(i)); }
  __device__ static int state(Pair p) { return __float_as_int(p.y); }
};
template <>
struct Score<double> {
  using Pair = double2;
  static constexpr int kMaxThreads = 384;
  __device__ static Pair pair(double v, int i) { return make_double2(v, __longlong_as_double(i)); }
  __device__ static int state(Pair p) { return static_cast<int>(__double_as_longlong(p.y)); }
};

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
template <typename S>
__device__ __forceinline__ bool better(S v, int i, S bv, int bi) { return v > bv || (v == bv && i < bi); }

template <typename S>
__device__ __forceinline__ void combine(S& v, int& i, int lane_mask) {
  const S ov = __shfl_xor_sync(0xffffffffu, v, lane_mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i, lane_mask);
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// is_beat as bits, bit s % 32 of word s / 32, with a zero word past the
// last state so that any 32-bit window starting at a state can be read.
__host__ __device__ inline int beat_words(int n_states) { return n_states / 32 + 2; }

// Bits s .. s + 31 of the beat bits: bit m tells whether state s + m is a beat state.
__device__ __forceinline__ unsigned beat_window(const unsigned* bits, int s) {
  return __funnelshift_r(bits[s >> 5], bits[(s >> 5) + 1], s & 31);
}

// The block's shared memory for scores of `score` bytes, the widest arrays
// first (the pairs, then the scores), then 4-byte, then 2-byte ones.
struct Layout {
  size_t red, trans, ring, tail, head, obs, first, len, lo, hi, clear, off, beat, surv, items, fc_stage, bytes = 0;
  __host__ __device__ size_t take(size_t n, size_t size) {
    const size_t at = bytes;
    bytes += n * size;
    return at;
  }
  __host__ __device__ Layout(int rounds, int threads, int n_int, int n_states, size_t score) {
    const size_t ni = n_int, ns = n_states, r = rounds;
    red = take(r * threads, 2 * score);
    trans = take(ni * ni, score);
    ring = take(ns, score);
    tail = take(r * ni, score);
    head = take(r * ni, score);
    obs = take(4 * r, score);  // two rounds' log_act then log_nact
    first = take(ni, 4);
    len = take(ni, 4);
    lo = take(ni, 4);
    hi = take(ni, 4);
    clear = take(ni, 4);
    off = take(2 * ni, 4);  // two rounds' ring offsets
    beat = take(beat_words(n_states), 4);
    surv = take(ns - r * ni, 4);
    items = take(r * ((ni + 31) / 32 * 32), 4);
    fc_stage = take(r * ni, 2);
    bytes = (bytes + 15) / 16 * 16;
  }
};

// best[t + m] for the n frames of a finished round, each over the block's
// per-thread maxima: the last warp reduces frames 0, warps, 2 warps, ..., the
// one before it frames 1, warps + 1, ... (the tempo step leaves the last
// warps the least work); a lane loads its up to 16 entries at once and
// combines them as a tree, then the warp's lanes combine by shuffles.
template <typename S>
__device__ __forceinline__ void reduce_best(const typename Score<S>::Pair* red, int n, int* best_out) {
  const int nt = blockDim.x, lane = threadIdx.x & 31, warps = nt >> 5;
  for (int m = warps - 1 - (threadIdx.x >> 5); m < n; m += warps) {
    S v[16];
    int i[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool on = 32 * k < nt;
      const typename Score<S>::Pair e = on ? red[m * nt + 32 * k + lane] : Score<S>::pair(-INFINITY, INT_MAX);
      v[k] = e.x;
      i[k] = Score<S>::state(e);
    }
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
#pragma unroll
      for (int k = 0; k + w < 16; k += 2 * w)
        if (better(v[k + w], i[k + w], v[k], i[k])) {
          v[k] = v[k + w];
          i[k] = i[k + w];
        }
    for (int o = 16; o > 0; o >>= 1) combine(v[0], i[0], o);
    if (lane == 0) best_out[m] = i[0];
  }
}

// Frame M's running first maximum of this thread, each state kept as its
// diagonal's base (the state less M; the order of states is kept): (v, base)
// if it beats (bv[M], bi[M]).
template <typename S, int kR, int M>
__device__ __forceinline__ void record(S v, int base, S (&bv)[kR], int (&bi)[kR]) {
  if constexpr (M < kR) {
    if (better(v, base, bv[M], bi[M])) {
      bv[M] = v;
      bi[M] = base;
    }
  }
}

// The same where every candidate of frame M this thread saw before had a
// lower state: a strict > keeps the first maximum. (A -inf candidate is not
// kept; if every state of a frame is -inf, the chain heads, kept by record,
// hold the first.)
template <typename S, int kR, int M>
__device__ __forceinline__ void record_first(S v, int base, S (&bv)[kR], int (&bi)[kR]) {
  if constexpr (M < kR) {
    if (v > bv[M]) {
      bv[M] = v;
      bi[M] = base;
    }
  }
}

// The observation of frame m for a state: bit m of bits says beat or not.
template <typename S, int kR, int M>
__device__ __forceinline__ S observation(unsigned bits, const S* la, const S* lna) {
  if constexpr (M < kR)
    return (bits >> M) & 1u ? la[M] : lna[M];
  else
    return S(0);
}

#define ZNS_FOR_STEPS(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16) X(17) X(18) X(19) \
  X(20) X(21) X(22) X(23)

// A diagonal through no beat state, from the round's start: `steps` adds of
// log_nact, its state at frame m being base + m; its thread sees its
// diagonals in increasing state order (record_first). kAll: steps is kR.
template <typename S, int kR, bool kAll>
__device__ __forceinline__ S walk_plain(S v, int steps, int base, const S* lna, S (&bv)[kR], int (&bi)[kR]) {
#define ZNS_WALK(M)                                  \
  if constexpr (M < kR) {                            \
    if constexpr (!kAll && M % 4 == 0)               \
      if (M >= steps) return v;                      \
    if (kAll || M < steps) {                         \
      v += lna[M];                                   \
      record_first<S, kR, M>(v, base, bv, bi);          \
    }                                                \
  }
  ZNS_FOR_STEPS(ZNS_WALK)
#undef ZNS_WALK
  return v;
}

// A diagonal through no beat state at a chain's end: `steps` adds of
// log_nact from the round's start, its state at frame m being base + m.
template <typename S, int kR>
__device__ __forceinline__ S walk_tail(S v, int steps, int base, const S* lna, S (&bv)[kR], int (&bi)[kR]) {
#define ZNS_WALK(M)                                  \
  if constexpr (M < kR) {                            \
    if constexpr (M % 4 == 0)                        \
      if (M >= steps) return v;                      \
    if (M < steps) {                                 \
      v += lna[M];                                   \
      record<S, kR, M>(v, base, bv, bi);                \
    }                                                \
  }
  ZNS_FOR_STEPS(ZNS_WALK)
#undef ZNS_WALK
  return v;
}

// A diagonal from the round's start: `steps` adds, frames 0 .. steps - 1, its
// state at frame m being base + m (bit m of bits: is that state a beat state).
// kAll: steps is kR, and the frames run without a test between them, so the
// compiler can overlap them; else steps is tested every 4 frames and the
// frames in between are predicated.
template <typename S, int kR, bool kAll>
__device__ __forceinline__ S walk(S v, int steps, int base, unsigned bits, const S* la, const S* lna, S (&bv)[kR],
                                  int (&bi)[kR]) {
#define ZNS_WALK(M)                                  \
  if constexpr (M < kR) {                            \
    if constexpr (!kAll && M % 4 == 0)               \
      if (M >= steps) return v;                      \
    if (kAll || M < steps) {                         \
      v += observation<S, kR, M>(bits, la, lna);        \
      record<S, kR, M>(v, base, bv, bi);                \
    }                                                \
  }
  ZNS_FOR_STEPS(ZNS_WALK)
#undef ZNS_WALK
  return v;
}

// A diagonal born at frame r with value v (its head, observation included),
// walked to frame n - 1: its state at frame m is fr + m (bit m of bits: is
// that state a beat state). Enters the unrolled frames at r; kAll: n is kR.
template <typename S, int kR, bool kAll>
__device__ __forceinline__ S walk_from(S v, int r, int n, int fr, unsigned bits, const S* la, const S* lna,
                                       S (&bv)[kR], int (&bi)[kR]) {
  switch (r) {
#define ZNS_ENTER(M) \
  case M:            \
    goto at##M;
    ZNS_FOR_STEPS(ZNS_ENTER)
#undef ZNS_ENTER
    default:
      return v;
  }
#define ZNS_FROM(M)                                    \
  at##M : if constexpr (M < kR) {                      \
    record<S, kR, M>(v, fr, bv, bi);                      \
    if constexpr (M + 1 >= kR) return v;               \
    if (!kAll && M + 1 >= n) return v;                 \
    v += observation<S, kR, M + 1>(bits, la, lna);        \
  }
  ZNS_FOR_STEPS(ZNS_FROM)
#undef ZNS_FROM
  return v;
}

// The tempo maxima into chain head j for the frames g, g + groups, ... (kF of
// them at most) of a round of n frames: over the column's band, from (-inf,
// row 0) with a strict >, so the first maximum, or row 0 if every candidate
// is -inf; the heads (with their observation) and the choices are staged.
template <typename S, int kR, int kF>
__device__ __forceinline__ void tempo(int g, int groups, int j, int n, int n_int, const S* trans, const S* tail,
                                      const int* lo, const int* hi, const unsigned* beat, const int* first,
                                      const S* obs_now, S* head, int16_t* fc_stage) {
  S cv[kF];
  int ci[kF];
#pragma unroll
  for (int u = 0; u < kF; ++u) {
    cv[u] = -INFINITY;  // with a strict > below: the first maximum, or row 0 if every candidate is -inf
    ci[u] = 0;
  }
  const int i1 = hi[j];
#pragma unroll 4
  for (int i = lo[j]; i <= i1; ++i) {
    const S t = trans[i * n_int + j];
#pragma unroll
    for (int u = 0; u < kF; ++u) {
      const S c = tail[min(g + u * groups, kR - 1) * n_int + i] + t;
      if (c > cv[u]) {
        cv[u] = c;
        ci[u] = i;
      }
    }
  }
  const int fb = (beat[first[j] >> 5] >> (first[j] & 31)) & 1u;
#pragma unroll
  for (int u = 0; u < kF; ++u) {
    const int r = g + u * groups;
    if (r < n) {
      head[r * n_int + j] = cv[u] + (fb ? obs_now[r] : obs_now[kR + r]);
      fc_stage[r * n_int + j] = static_cast<int16_t>(ci[u]);
    }
  }
}

template <typename S, int kR>
__global__ void __launch_bounds__(Score<S>::kMaxThreads)
viterbi_kernel(const S* __restrict__ log_act, const S* __restrict__ log_nact, int T, const S* __restrict__ log_trans,
               const int* __restrict__ firsts, const int* __restrict__ lasts, const int* __restrict__ band_lo,
               const int* __restrict__ band_hi, int n_int, const uint8_t* __restrict__ is_beat, int n_states, S v0,
               S* __restrict__ v_final, int16_t* __restrict__ fc, int* __restrict__ best) {
  static_assert(kR >= 1 && kR <= 24, "ZNS_FOR_STEPS unrolls 24 frames");
  constexpr int kF = (kR + 3) / 4;  // tempo frames a unit in a narrow block: 4 units or fewer a column
  extern __shared__ __align__(16) unsigned char smem[];
  using Pair = typename Score<S>::Pair;
  const Layout lay(kR, blockDim.x, n_int, n_states, sizeof(S));
  Pair* red = reinterpret_cast<Pair*>(smem + lay.red);  // (kR, threads): (value, state as int bits)
  S* trans = reinterpret_cast<S*>(smem + lay.trans);    // (n_int, n_int), from-major
  S* ring = reinterpret_cast<S*>(smem + lay.ring);      // chain j's slots: first[j] .. + len[j]
  S* tail = reinterpret_cast<S*>(smem + lay.tail);      // (kR, n_int)
  S* head = reinterpret_cast<S*>(smem + lay.head);      // (kR, n_int)
  S* obs = reinterpret_cast<S*>(smem + lay.obs);
  int* first = reinterpret_cast<int*>(smem + lay.first);
  int* len = reinterpret_cast<int*>(smem + lay.len);
  int* lo = reinterpret_cast<int*>(smem + lay.lo);
  int* hi = reinterpret_cast<int*>(smem + lay.hi);
  int* clear = reinterpret_cast<int*>(smem + lay.clear);  // 1 + the last beat position of each chain, or 0
  int* off = reinterpret_cast<int*>(smem + lay.off);
  unsigned* beat = reinterpret_cast<unsigned*>(smem + lay.beat);
  int* surv = reinterpret_cast<int*>(smem + lay.surv);  // (chain << 16) | position, see below
  int* items = reinterpret_cast<int*>(smem + lay.items);  // (r << 16) | chain, see below
  int16_t* fc_stage = reinterpret_cast<int16_t*>(smem + lay.fc_stage);  // (kR, n_int)

  const int tid = threadIdx.x, nt = blockDim.x, n_surv = n_states - kR * n_int;
  constexpr int kNone = INT_MAX - 32;  // a base above every state, plus any frame of a round
  // The items (r, j) of the last kR positions run r by r, each r on whole
  // warps (n_int rounded up to 32), so a warp's lanes enter and leave their
  // walks at the same frame.
  const int n_pad = (n_int + 31) / 32 * 32;
  for (int k = tid; k < kR * n_pad; k += nt) items[k] = ((k / n_pad) << 16) | (k % n_pad);
  const size_t b = blockIdx.x;
  const S* la_row = log_act + b * T;
  const S* lna_row = log_nact + b * T;
  for (int k = tid; k < n_int * n_int; k += nt) trans[k] = log_trans[k];
  for (int j = tid; j < n_int; j += nt) {
    const int L = lasts[j] - firsts[j] + 1;
    first[j] = firsts[j];
    len[j] = L;
    lo[j] = band_lo[j];
    hi[j] = band_hi[j];
    off[j] = 0;
    int c = 0;
    for (int p = 0; p < L; ++p)
      if (is_beat[firsts[j] + p]) c = p + 1;
    clear[j] = c;
  }
  for (int w = tid; w < beat_words(n_states); w += nt) {
    unsigned word = 0;
    for (int q = 0; q < 32 && 32 * w + q < n_states; ++q) word |= (is_beat[32 * w + q] ? 1u : 0u) << q;
    beat[w] = word;
  }
  __syncthreads();
  // Positions 0 .. L - kR - 1 of every chain outlive a full round. Those
  // whose next kR states hold no beat state (p + 1 >= clear) are listed
  // first, in state order, n_plain of them; then the others.
  int n_plain = 0;
  for (int j = 0; j < n_int; ++j) n_plain += len[j] - kR - min(max(clear[j] - 1, 0), len[j] - kR);
  for (int j = tid; j < n_int; j += nt) {
    int at_plain = 0, at_beat = n_plain;
    for (int i = 0; i < j; ++i) {
      const int c0 = min(max(clear[i] - 1, 0), len[i] - kR);
      at_plain += len[i] - kR - c0;
      at_beat += c0;
    }
    const int c0 = min(max(clear[j] - 1, 0), len[j] - kR);
    for (int p = 0; p < len[j] - kR; ++p) surv[p < c0 ? at_beat + p : at_plain + p - c0] = (j << 16) | p;
  }
  for (int s = tid; s < n_states; s += nt) ring[s] = v0;
  if (tid < 2 * kR && tid % kR < T) obs[tid] = (tid < kR ? la_row : lna_row)[tid % kR];
  __syncthreads();

  // The diagonal at position p of chain j (L states) at a round's start
  // lives in ring slot first[j] + (L - 1 - p + off[j]) mod L, off[j] being
  // the frames done so far mod L: a diagonal keeps its slot, and the one born
  // at frame r of a round takes the slot of the one whose tail frame r read.
  int prev_t0 = 0, prev_n = 0;  // the round whose best states are still to reduce
  for (int t0 = 0, round = 0; t0 < T; t0 += kR, ++round) {
    const int n = min(kR, T - t0);
    const S* obs_now = obs + (round & 1) * 2 * kR;
    const int* off_now = off + (round & 1) * n_int;
    // The next round's observations, loaded now and stored after the first barrier.
    const int next_obs_at = tid < 2 * kR && t0 + kR + tid % kR < T ? t0 + kR + tid % kR : -1;
    const S next_obs = next_obs_at >= 0 ? (tid < kR ? la_row : lna_row)[next_obs_at] : S(0);
    S la[kR], lna[kR], bv[kR];
    int bi[kR];
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      la[m] = obs_now[m];
      lna[m] = obs_now[kR + m];
      bv[m] = -INFINITY;
      bi[m] = kNone;
    }

    // A. The diagonals that outlive the round walk all n frames: first those
    // through no beat state, in state order, then the others.
    const bool all = n == kR;
    for (int idx = tid; idx < n_plain; idx += nt) {
      const int e = surv[idx], j = e >> 16, p = e & 0xffff, L = len[j], f = first[j];
      int q = L - 1 - p + off_now[j];
      if (q >= L) q -= L;
      ring[f + q] = all ? walk_plain<S, kR, true>(ring[f + q], n, f + p + 1, lna, bv, bi)
                        : walk_plain<S, kR, false>(ring[f + q], n, f + p + 1, lna, bv, bi);
    }
    for (int idx = n_plain + tid; idx < n_surv; idx += nt) {
      const int e = surv[idx], j = e >> 16, p = e & 0xffff, L = len[j], f = first[j];
      int q = L - 1 - p + off_now[j];
      if (q >= L) q -= L;
      const int base = f + p + 1;  // its state at frame m is base + m
      const unsigned bits = beat_window(beat, base);
      ring[f + q] = all ? walk<S, kR, true>(ring[f + q], n, base, bits, la, lna, bv, bi)
                        : walk<S, kR, false>(ring[f + q], n, base, bits, la, lna, bv, bi);
    }
    // The last kR positions of each chain: the diagonal there reaches the
    // chain's last state after r frames, and frame r reads it there as a tail.
    for (int item = tid; item < kR * n_pad; item += nt) {
      const int r = items[item] >> 16, j = items[item] & 0xffff;
      if (j >= n_int) continue;
      const int L = len[j], f = first[j];
      int q = r + off_now[j];
      if (q >= L) q -= L;
      const int base = f + L - r;  // its state at frame m is base + m
      const S v = L - r >= clear[j] ? walk_tail<S, kR>(ring[f + q], min(r, n), base, lna, bv, bi)
                                     : walk<S, kR, false>(ring[f + q], min(r, n), base, beat_window(beat, base), la,
                                                          lna, bv, bi);
      if (r < n)
        tail[r * n_int + j] = v;
      else
        ring[f + q] = v;  // a last round shorter than kR: it outlives the round
    }
    __syncthreads();

    // B. The previous round's best states; the next round's observations and
    // ring offsets; the tempo maxima of this round's frames into the chain
    // heads.
    if (prev_n > 0) reduce_best<S>(red, prev_n, best + b * T + prev_t0);
    if (next_obs_at >= 0) obs[((round + 1) & 1) * 2 * kR + tid] = next_obs;
    for (int j = tid; j < n_int; j += nt) {
      const int o = off_now[j] + n;
      off[((round + 1) & 1) * n_int + j] = o >= len[j] ? o - len[j] : o;
    }
    // A unit is kF or fewer frames of a column; 2 where the block has the
    // threads for that.
    const int wide = max(1, min(n, nt / n_int));
    if ((n + wide - 1) / wide <= 2) {
      for (int item = tid; item < wide * n_int; item += nt)
        tempo<S, kR, 2>(item / n_int, wide, item % n_int, n, n_int, trans, tail, lo, hi, beat, first, obs_now, head,
                     fc_stage);
    } else {
      const int groups = (n + kF - 1) / kF;
      for (int item = tid; item < groups * n_int; item += nt)
        tempo<S, kR, kF>(item / n_int, groups, item % n_int, n, n_int, trans, tail, lo, hi, beat, first, obs_now, head,
                      fc_stage);
    }
    __syncthreads();

    // C. The diagonal born at frame r of chain j takes its slot and walks
    // from its head to the round's end.
    for (int item = tid; item < n * n_pad; item += nt) {
      const int r = items[item] >> 16, j = items[item] & 0xffff;
      if (j >= n_int) continue;
      const int L = len[j], f = first[j];
      int q = r + off_now[j];
      if (q >= L) q -= L;
      const unsigned bits = beat_window(beat, f) << r;  // bit m: state f + m - r, for m >= r
      ring[f + q] = all ? walk_from<S, kR, true>(head[r * n_int + j], r, n, f - r, bits, la, lna, bv, bi)
                        : walk_from<S, kR, false>(head[r * n_int + j], r, n, f - r, bits, la, lna, bv, bi);
    }
#pragma unroll
    for (int m = 0; m < kR; ++m)
      if (m < n) {
        red[m * nt + tid] = Score<S>::pair(bv[m], bi[m] + m);
      }
    int16_t* fc_out = fc + (b * T + t0) * n_int;
    for (int k = tid; k < n * n_int; k += nt) fc_out[k] = fc_stage[k];
    prev_t0 = t0;
    prev_n = n;
    __syncthreads();
  }
  if (prev_n > 0) reduce_best<S>(red, prev_n, best + b * T + prev_t0);
  const int* off_end = off + (((T + kR - 1) / kR) & 1) * n_int;
  for (int j = tid >> 5; j < n_int; j += nt >> 5) {
    const int L = len[j], f = first[j];
    for (int p = tid & 31; p < L; p += 32) {
      int q = L - 1 - p + off_end[j];
      if (q >= L) q -= L;
      v_final[b * n_states + f + p] = ring[f + q];
    }
  }
}

template <typename S, int kR>
int launch(const void* log_act, const void* log_nact, long long batch, long long T, const void* log_trans,
           const void* firsts, const void* lasts, const void* band_lo, const void* band_hi, int n_int,
           const void* is_beat, int n_states, S v0, int threads, void* v_final, void* fc, void* best,
           cudaStream_t stream) {
  const size_t smem = Layout(kR, threads, n_int, n_states, sizeof(S)).bytes;
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(viterbi_kernel<S, kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_kernel<S, kR><<<static_cast<unsigned>(batch), threads, smem, stream>>>(
      static_cast<const S*>(log_act), static_cast<const S*>(log_nact), static_cast<int>(T),
      static_cast<const S*>(log_trans), static_cast<const int*>(firsts), static_cast<const int*>(lasts),
      static_cast<const int*>(band_lo), static_cast<const int*>(band_hi), n_int, static_cast<const uint8_t*>(is_beat),
      n_states, v0, static_cast<S*>(v_final), static_cast<int16_t*>(fc), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int dispatch(const void* log_act, const void* log_nact, long long batch, long long T, const void* log_trans,
             const void* firsts, const void* lasts, const void* band_lo, const void* band_hi, int n_int,
             const void* is_beat, int n_states, S v0, int frames_per_round, int threads, void* v_final, void* fc,
             void* best, void* stream) {
  if (batch < 1 || batch > INT_MAX || T < 0 || T > INT_MAX || n_int < 1 || n_int > SHRT_MAX || n_states < n_int ||
      threads < 64 || threads > Score<S>::kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZNS_ROUND(R)                                                                                              \
  case R:                                                                                                         \
    return launch<S, R>(log_act, log_nact, batch, T, log_trans, firsts, lasts, band_lo, band_hi, n_int, is_beat,  \
                        n_states, v0, threads, v_final, fc, best, st);
  switch (frames_per_round) {  // dbn_kernel.ROUND_FRAMES
    ZNS_ROUND(1)
    ZNS_ROUND(2)
    ZNS_ROUND(3)
    ZNS_ROUND(4)
    ZNS_ROUND(6)
    ZNS_ROUND(8)
    ZNS_ROUND(12)
    ZNS_ROUND(16)
    ZNS_ROUND(17)
    ZNS_ROUND(24)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ZNS_ROUND
}

}  // namespace
