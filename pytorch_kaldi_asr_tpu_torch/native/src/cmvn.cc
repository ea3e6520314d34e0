// CMVN accumulation and application over one float32 matrix: the port's
// copy of the JAX package's native/src/cmvn.cc (the role of Kaldi's
// compute-cmvn-stats and apply-cmvn).  Bound by native/__init__.py
// (cmvn_accumulate, cmvn_apply) and, as in the JAX package, called on no
// path: tools/cmvn.py does the work in numpy.  The two agree within
// rounding: apply multiplies by 1/sqrt(var) where tools/cmvn.py divides by
// sqrt(var), and accumulate adds row by row where tools/cmvn.py adds each
// utterance's sum.

#include <cmath>
#include <cstdint>

extern "C" {

// Accumulate one matrix into stats [2, dim+1] (Kaldi layout: row 0 = sums +
// frame count in last col, row 1 = sum of squares).
int pka_cmvn_accumulate(const float* mat, int32_t rows, int32_t cols,
                        double* stats) {
  double* sums = stats;
  double* sqs = stats + cols + 1;
  for (int32_t i = 0; i < rows; ++i) {
    const float* row = mat + static_cast<int64_t>(i) * cols;
    for (int32_t j = 0; j < cols; ++j) {
      sums[j] += row[j];
      sqs[j] += static_cast<double>(row[j]) * row[j];
    }
  }
  sums[cols] += rows;
  return 0;
}

// Apply mean (and optionally variance) normalization in place.
int pka_cmvn_apply(float* mat, int32_t rows, int32_t cols,
                   const double* stats, int norm_vars) {
  const double* sums = stats;
  const double* sqs = stats + cols + 1;
  const double count = sums[cols];
  if (count <= 0) return -1;
  for (int32_t j = 0; j < cols; ++j) {
    const double mean = sums[j] / count;
    double scale = 1.0;
    if (norm_vars) {
      double var = sqs[j] / count - mean * mean;
      if (var < 1e-20) var = 1e-20;
      scale = 1.0 / std::sqrt(var);
    }
    for (int32_t i = 0; i < rows; ++i) {
      float* v = mat + static_cast<int64_t>(i) * cols + j;
      *v = static_cast<float>((*v - mean) * scale);
    }
  }
  return 0;
}

}  // extern "C"
