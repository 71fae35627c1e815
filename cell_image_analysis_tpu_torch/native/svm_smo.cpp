// One-class SVM dual solver (SMO with second-order working-set selection).
//
// The host half of `models/svm.OneClassSVM.fit`: the kernel matrix is
// computed on the device, and this loop runs the sequential dual
// optimization on the host, step for step what the loop of
// `models/smo.py`'s `smo_one_class_np` does.  The caller hands in the
// starting point (alpha and the gradient G = K @ alpha, which numpy
// computes) and computes rho from the final alpha and G, so that the
// result equals the numpy specification bit for bit: a sum in another
// order (a BLAS matvec, a pairwise mean) would not.  `models/smo.py`
// builds this file with g++ at first use and loads it with ctypes.
//
// Problem:  min 1/2 a^T Q a   s.t. 0 <= a_i <= 1, sum a_i = nu * l.

#include <cmath>
#include <cstddef>
#include <limits>

namespace {
constexpr double kTau = 1e-12;
}

extern "C" {

// Iterates from (alpha, G) in place until the stopping rule or max_iter.
// K is row-major (l x l) and is not modified.  Returns the iteration count
// as the numpy loop reports it (the index of the last iteration, plus 1).
long smo_one_class_iterate(const double* K, int l, double tol, long max_iter,
                           double* alpha, double* G) {
  long it = 0;
  for (; it < max_iter; ++it) {
    // i = argmin_{a_i < 1} G_i ;  stopping: max_{a>0} G - min_{a<1} G < tol
    int i = -1;
    double gmin = std::numeric_limits<double>::infinity();
    double gmax = -std::numeric_limits<double>::infinity();
    for (int t = 0; t < l; ++t) {
      if (alpha[t] < 1.0 - kTau && G[t] < gmin) { gmin = G[t]; i = t; }
      if (alpha[t] > kTau && G[t] > gmax) gmax = G[t];
    }
    if (i < 0 || gmax - gmin < tol) break;

    // second-order selection of j among {a_j > 0, G_j > G_i}
    const double* Ki = K + static_cast<size_t>(i) * l;
    const double Kii = Ki[i];
    int j = -1;
    double best = -std::numeric_limits<double>::infinity();
    for (int t = 0; t < l; ++t) {
      if (alpha[t] <= kTau) continue;
      const double diff = G[t] - gmin;  // = G_t - G_i
      if (diff <= 0) continue;
      double quad = Kii + K[static_cast<size_t>(t) * l + t] - 2.0 * Ki[t];
      if (quad <= 0) quad = kTau;
      const double gain = diff * diff / quad;
      if (gain > best) { best = gain; j = t; }
    }
    if (j < 0) break;

    const double* Kj = K + static_cast<size_t>(j) * l;
    double quad = Kii + Kj[j] - 2.0 * Ki[j];
    if (quad <= 0) quad = kTau;
    const double delta = (G[j] - G[i]) / quad;
    const double s = alpha[i] + alpha[j];
    double ai = alpha[i] + delta;
    const double lo = s > 1.0 ? s - 1.0 : 0.0;
    const double hi = s < 1.0 ? s : 1.0;
    if (ai < lo) ai = lo;
    if (ai > hi) ai = hi;
    const double aj = s - ai;
    const double dai = ai - alpha[i];
    const double daj = aj - alpha[j];
    if (std::fabs(dai) < kTau && std::fabs(daj) < kTau) break;
    alpha[i] = ai;
    alpha[j] = aj;
    for (int t = 0; t < l; ++t) G[t] += Ki[t] * dai + Kj[t] * daj;
  }
  return it < max_iter ? it + 1 : max_iter;
}

}  // extern "C"
