// The DBN Viterbi forward pass in float64, the host C++ DBN's own adds
// (dbn_viterbi.cpp): the C entry of viterbi_kernel<double>
// (dbn_viterbi.cuh). It replaces no TPU kernel: the JAX package runs its
// offline DBN on the host; this runs its forward pass on the card for a
// caller there (decode/dbn_device.viterbi_path_f64).

#include "dbn_viterbi.cuh"

extern "C" {

// As zns_dbn_viterbi (dbn_viterbi.cu) in double: log_act, log_nact,
// log_trans, v0 and v_final are float64, and threads at most 384.
int zns_dbn_viterbi_f64(const void* log_act, const void* log_nact, long long batch, long long T,
                        const void* log_trans, const void* firsts, const void* lasts, const void* band_lo,
                        const void* band_hi, int n_int, const void* is_beat, int n_states, double v0,
                        int frames_per_round, int threads, void* v_final, void* fc, void* best, void* stream) {
  return dispatch<double>(log_act, log_nact, batch, T, log_trans, firsts, lasts, band_lo, band_hi, n_int, is_beat,
                          n_states, v0, frames_per_round, threads, v_final, fc, best, stream);
}

}  // extern "C"
