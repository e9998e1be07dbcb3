// Native Viterbi core for the DBN beat decoder (decode/dbn.py).
//
// Same recursion as the numpy reference implementation: beat-position chains
// advance deterministically (a shift), tempo changes happen only at beat
// boundaries through an (n_int x n_int) transition matrix, observations are
// two-valued per frame (in-beat-window vs out). The numpy path spends its
// time in per-frame python/numpy dispatch; this loop runs the whole
// recursion in one call. Exposed via ctypes: decode/dbn_native.py builds it
// with g++ -O3 -fPIC -shared -std=c++17 at first use (no -march=native, so
// the library runs on any x86-64 host).
//
// Layout contract (matches decode/dbn.py::_state_space):
//   states are grouped by interval, interval i occupying
//   [firsts[i], firsts[i] + intervals[i]) with lasts[i] its final state.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>

extern "C" {

// The state path from state `start` at the last frame back to the first:
// a first state of a chain steps to the last state of the chain that
// first_choice[t] names, any other state to the one before it. Shared by
// dbn_viterbi and the forward pass on a card (decode/dbn_device.py).
void dbn_backtrack(
    const int16_t* first_choice,  // [T * n_int] the tempo choice into each chain's first state
    int64_t T,
    int64_t n_int,
    int64_t n_states,
    const int64_t* firsts,        // [n_int]
    const int64_t* lasts,         // [n_int]
    int64_t start,                // the state at frame T - 1
    int64_t* path)                // [T] out
{
    // first-state lookup: map state -> interval index if first else -1
    std::vector<int32_t> first_of(n_states, -1);
    for (int64_t i = 0; i < n_int; ++i) first_of[firsts[i]] = (int32_t)i;

    int64_t s = start;
    for (int64_t t = T - 1; t >= 0; --t) {
        path[t] = s;
        int32_t fi = first_of[s];
        if (fi >= 0)
            s = lasts[first_choice[(size_t)t * n_int + fi]];
        else
            s -= 1;
    }
}

// Outputs:
//   path[t]  : decoded state index per frame (int64, length T)
void dbn_viterbi(
    const double* log_act,    // [T] log p(obs | beat state)
    const double* log_nact,   // [T] log p(obs | non-beat state)
    int64_t T,
    const int32_t* intervals, // [n_int]
    int64_t n_int,
    const double* log_trans,  // [n_int * n_int] from-major
    const uint8_t* is_beat,   // [n_states]
    int64_t n_states,
    const int64_t* firsts,    // [n_int]
    const int64_t* lasts,     // [n_int]
    int64_t* path)            // [T] out
{
    std::vector<double> v(n_states, -std::log((double)n_states));
    std::vector<double> v_new(n_states);
    // Backpointers only needed at first-states: which FROM-interval won.
    std::vector<int16_t> first_choice((size_t)T * n_int);

    std::vector<double> last_vals(n_int);
    for (int64_t t = 0; t < T; ++t) {
        for (int64_t i = 0; i < n_int; ++i) last_vals[i] = v[lasts[i]];
        // Tempo transitions into each first state.
        int16_t* fc = &first_choice[(size_t)t * n_int];
        for (int64_t j = 0; j < n_int; ++j) {
            double best = -INFINITY;
            int16_t arg = 0;
            for (int64_t i = 0; i < n_int; ++i) {
                double cand = last_vals[i] + log_trans[i * n_int + j];
                if (cand > best) { best = cand; arg = (int16_t)i; }
            }
            fc[j] = arg;
            v_new[firsts[j]] = best;
        }
        // Within-chain advance: state s takes v[s-1] (firsts already set).
        // Copy with stride 1; overwrite of firsts happens above so do the
        // shift first into a temp? Order matters: fill shift, then firsts.
        // We already wrote firsts into v_new; shift everything else.
        {
            // shift: v_new[s] = v[s-1] for non-first s
            int64_t idx = 0;
            for (int64_t i = 0; i < n_int; ++i) {
                int64_t f = firsts[i];
                int64_t len = intervals[i];
                // states f+1 .. f+len-1 take v[f .. f+len-2]
                std::memcpy(&v_new[f + 1], &v[f], sizeof(double) * (size_t)(len - 1));
                idx += len;
            }
            (void)idx;
        }
        const double la = log_act[t], lna = log_nact[t];
        for (int64_t s = 0; s < n_states; ++s)
            v_new[s] += is_beat[s] ? la : lna;
        v.swap(v_new);
    }

    // Backtrack from the first state with the largest final score.
    int64_t s = 0;
    double best = -INFINITY;
    for (int64_t i = 0; i < n_states; ++i)
        if (v[i] > best) { best = v[i]; s = i; }
    dbn_backtrack(first_choice.data(), T, n_int, n_states, firsts, lasts, s, path);
}

}  // extern "C"
