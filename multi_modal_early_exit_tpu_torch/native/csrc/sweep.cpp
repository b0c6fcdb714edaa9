// Host-side threshold-mixture sweep, C++/OpenMP.
//
// Equivalent of the reference's joblib/multiprocessing mixture
// search (EE/thresh.py:188-225 opt0_2D, EE/large_scale.py:206-215): for each
// per-exit threshold vector, assign every sample to its first passing exit
// and reduce to (accuracy, average_exit). The (E,N) score matrix stays in
// L1/L2; the M-mixture loop parallelizes across cores with no Python
// pickling or process-pool overhead.
//
// Exported C ABI (consumed by native/sweep.py via ctypes):
//   mixture_sweep(scores[E*N], correct[E*N], mixtures[M*E], E, N, M,
//                 out_acc[M], out_avg[M])
//
// Semantics match thresholds.assign_exits_2d: pass test is score >= t;
// argmax over exits of the pass matrix — i.e. if no exit passes, exit 0
// (argmax of all-false) is selected, exactly like the numpy/torch paths.

#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

void mixture_sweep(const float* scores,    // (E, N) row-major
                   const float* correct,   // (E, N) 1.0 if argmax == label
                   const float* mixtures,  // (M, E)
                   int64_t E, int64_t N, int64_t M,
                   float* out_acc,         // (M,)
                   float* out_avg) {       // (M,)
#pragma omp parallel for schedule(static)
  for (int64_t m = 0; m < M; ++m) {
    const float* t = mixtures + m * E;
    double acc = 0.0, avg = 0.0;
    for (int64_t n = 0; n < N; ++n) {
      int64_t chosen = 0;
      bool found = false;
      for (int64_t e = 0; e < E; ++e) {
        if (scores[e * N + n] >= t[e]) {
          chosen = e;
          found = true;
          break;
        }
      }
      if (!found) chosen = 0;  // argmax of all-false rows = 0
      acc += correct[chosen * N + n];
      avg += static_cast<double>(chosen);
    }
    out_acc[m] = static_cast<float>(acc / N);
    out_avg[m] = static_cast<float>(avg / N);
  }
}

// Global-threshold sweep over T thresholds (the opt0 pattern,
// EE/thresh.py:106-131): same first-pass rule with a scalar threshold,
// but samples with no passing exit fall through to the LAST exit.
void global_sweep(const float* scores,   // (E, N)
                  const float* correct,  // (E, N)
                  const float* thresholds,  // (T,)
                  int64_t E, int64_t N, int64_t T,
                  float* out_acc,        // (T,)
                  float* out_avg) {      // (T,)
#pragma omp parallel for schedule(static)
  for (int64_t ti = 0; ti < T; ++ti) {
    const float t = thresholds[ti];
    double acc = 0.0, avg = 0.0;
    for (int64_t n = 0; n < N; ++n) {
      int64_t chosen = E - 1;
      for (int64_t e = 0; e < E; ++e) {
        if (scores[e * N + n] >= t) {
          chosen = e;
          break;
        }
      }
      acc += correct[chosen * N + n];
      avg += static_cast<double>(chosen);
    }
    out_acc[ti] = static_cast<float>(acc / N);
    out_avg[ti] = static_cast<float>(avg / N);
  }
}

}  // extern "C"
