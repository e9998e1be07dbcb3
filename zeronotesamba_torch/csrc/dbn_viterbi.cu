// The batched DBN Viterbi forward pass in float32: the C entry of
// viterbi_kernel<float> (dbn_viterbi.cuh, where the kernel and its design
// are described). Replaces zeronotesamba_tpu/decode/dbn_jax.py,
// _viterbi_scan under vmap.

#include "dbn_viterbi.cuh"

extern "C" {

// log_act, log_nact: (batch, T) float32. log_trans: (n_int, n_int) float32,
// from-major, finite or -inf. firsts, lasts: (n_int,) int32, consecutive
// chains covering the states. band_lo, band_hi: (n_int,) int32, each
// column's first and last row of finite log_trans ((0, -1) for none).
// is_beat: (n_states,) uint8. frames_per_round: R, one of the round lengths
// instantiated in dispatch (dbn_viterbi.cuh) and at most the shortest
// chain's length. threads: a block's threads, a multiple of 32 from 64 (two
// rounds' observations are loaded a value a thread) up to 512.
// Outputs: v_final (batch, n_states) float32, fc (batch, T, n_int) int16,
// best (batch, T) int32. All pointers are device memory, contiguous.
// Returns cudaGetLastError() after the launch.
int zns_dbn_viterbi(const void* log_act, const void* log_nact, long long batch, long long T, const void* log_trans,
                    const void* firsts, const void* lasts, const void* band_lo, const void* band_hi, int n_int,
                    const void* is_beat, int n_states, float v0, int frames_per_round, int threads, void* v_final,
                    void* fc, void* best, void* stream) {
  return dispatch<float>(log_act, log_nact, batch, T, log_trans, firsts, lasts, band_lo, band_hi, n_int, is_beat,
                         n_states, v0, frames_per_round, threads, v_final, fc, best, stream);
}

}  // extern "C"
