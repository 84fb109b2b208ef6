// Monotonic Alignment Search — C++/OpenMP host kernel.
//
// A copy of tpu_tts/ops/mas_cpp.cpp, the host counterpart of Coqui TTS's
// Cython kernel (TTS/tts/utils/monotonic_align/core.pyx): a banded
// Viterbi DP over a [t_x, t_y] log-probability matrix followed by backtrace.
// The DP is done in a separate scratch buffer (the Cython version mutates the
// logp in place); the band bounds skip unreachable cells, so per-sample cost
// is O(t_x * t_y) with a tight inner loop. Batch items run under OpenMP.
//
// Exposed via ctypes from tpu_tts_torch/ops/mas.py (built at first use with g++).

#include <algorithm>
#include <cstring>
#include <vector>

extern "C" {

// paths:  [B, Tx, Ty] int32 output (0/1)
// values: [B, Tx, Ty] float32 log-probs (not modified)
// t_xs, t_ys: per-sample valid lengths
void maximum_path_batch(int *paths, const float *values, const int *t_xs,
                        const int *t_ys, int batch, int Tx, int Ty,
                        float max_neg_val) {
#pragma omp parallel
  {
    std::vector<float> dp(static_cast<size_t>(Tx) * Ty);
#pragma omp for schedule(dynamic)
    for (int b = 0; b < batch; ++b) {
      const float *value = values + static_cast<size_t>(b) * Tx * Ty;
      int *path = paths + static_cast<size_t>(b) * Tx * Ty;
      const int tx = t_xs[b];
      const int ty = t_ys[b];

      // forward DP: dp[x, y] = value[x, y] + max(dp[x, y-1], dp[x-1, y-1])
      for (int y = 0; y < ty; ++y) {
        const int x_lo = std::max(0, tx + y - ty);
        const int x_hi = std::min(tx, y + 1);
        for (int x = x_lo; x < x_hi; ++x) {
          float v_cur = (x == y) ? max_neg_val : dp[static_cast<size_t>(x) * Ty + (y - 1)];
          float v_prev;
          if (x == 0) {
            v_prev = (y == 0) ? 0.f : max_neg_val;
          } else {
            v_prev = dp[static_cast<size_t>(x - 1) * Ty + (y - 1)];
          }
          dp[static_cast<size_t>(x) * Ty + y] =
              std::max(v_cur, v_prev) + value[static_cast<size_t>(x) * Ty + y];
        }
      }

      // backtrace
      int index = tx - 1;
      for (int y = ty - 1; y >= 0; --y) {
        path[static_cast<size_t>(index) * Ty + y] = 1;
        if (index != 0 &&
            (index == y || dp[static_cast<size_t>(index) * Ty + (y - 1)] <
                               dp[static_cast<size_t>(index - 1) * Ty + (y - 1)])) {
          --index;
        }
      }
    }
  }
}

}  // extern "C"
