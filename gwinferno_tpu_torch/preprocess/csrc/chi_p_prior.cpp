// Native (C++/OpenMP) implementation of the chi_p | chi_eff, q conditional
// fiducial prior -- the per-sample rejection-MC + weighted-Gaussian-KDE
// evaluation that dominates effective-spin catalog preprocessing (the
// reference implements it per scalar sample in Python/scipy and runs a
// double loop over events x samples; gwinferno/preprocess/priors.py:247-333,
// data_collection.py:210-353).
//
// Algorithm per (chi_p, chi_eff, q) triple (identical math to the Python
// path, reference-parity):
//   1. draw (a1, a2, cos t2) uniform; solve cos t1 from the chi_eff
//      constraint; rejection-resample until physical;
//   2. chi_p draws + Jacobian weights (1+q)/a1;
//   3. weighted Gaussian KDE (Scott bandwidth) evaluated on a 50-point grid
//      inside (0, max_chi_p), zero-padded at the boundaries, trapezoid-
//      normalized;
//   4. linear interpolation at the requested chi_p.
//
// Exposed as a flat C ABI for ctypes; see
// gwinferno_tpu_torch/preprocess/native.py for the Python wrapper, which
// builds this file with g++ (-O3 -march=native -fPIC -fopenmp -std=c++17
// -shared) into gwinferno_tpu_torch/_build/.  A copy of the JAX package's
// native/src/chi_p_prior.cpp: the same source gives the same numbers.

#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kGridInterior = 50;
constexpr int kGrid = kGridInterior + 2;  // + zero-padded endpoints

struct Draws {
  std::vector<double> chi_p;
  std::vector<double> weight;
};

// Rejection sampling of component spins consistent with a fixed chi_eff.
Draws draw_conditional_spins(double chi_eff, double q, double a_max,
                             int ndraws, std::mt19937_64& rng) {
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  Draws out;
  out.chi_p.resize(ndraws);
  out.weight.resize(ndraws);
  const double pair_factor = (3.0 + 4.0 * q) / (4.0 + 3.0 * q);
  for (int i = 0; i < ndraws; ++i) {
    double a1, a2, cost1, cost2;
    // redraw until the implied primary tilt is physical
    do {
      a1 = unif(rng) * a_max;
      a2 = unif(rng) * a_max;
      cost2 = 2.0 * unif(rng) - 1.0;
      cost1 = (chi_eff * (1.0 + q) - q * a2 * cost2) / a1;
    } while (cost1 < -1.0 || cost1 > 1.0);
    const double sint1 = std::sqrt(std::max(0.0, 1.0 - cost1 * cost1));
    const double sint2 = std::sqrt(std::max(0.0, 1.0 - cost2 * cost2));
    const double cp1 = a1 * sint1;
    const double cp2 = pair_factor * q * a2 * sint2;
    out.chi_p[i] = cp1 > cp2 ? cp1 : cp2;
    out.weight[i] = (1.0 + q) / a1;  // Jacobian weight
  }
  return out;
}

// Weighted Gaussian KDE with Scott's rule, evaluated at grid points.
void weighted_kde_on_grid(const Draws& d, const double* grid, int ngrid,
                          double* vals) {
  const int n = static_cast<int>(d.chi_p.size());
  double wsum = 0.0, mean = 0.0;
  for (int i = 0; i < n; ++i) wsum += d.weight[i];
  for (int i = 0; i < n; ++i) mean += d.weight[i] * d.chi_p[i];
  mean /= wsum;
  double var = 0.0, w2 = 0.0;
  for (int i = 0; i < n; ++i) {
    const double dx = d.chi_p[i] - mean;
    var += d.weight[i] * dx * dx;
    w2 += d.weight[i] * d.weight[i];
  }
  // scipy's weighted unbiased variance + effective sample size for Scott
  var /= (wsum - w2 / wsum);
  const double neff = wsum * wsum / w2;
  const double bw = std::pow(neff, -0.2) * std::sqrt(var);
  const double inv_bw = 1.0 / bw;
  const double norm = 1.0 / (wsum * bw * std::sqrt(2.0 * M_PI));
  for (int g = 0; g < ngrid; ++g) {
    double acc = 0.0;
    for (int i = 0; i < n; ++i) {
      const double z = (grid[g] - d.chi_p[i]) * inv_bw;
      acc += d.weight[i] * std::exp(-0.5 * z * z);
    }
    vals[g] = acc * norm;
  }
}

double eval_one(double chi_p, double chi_eff, double q, double a_max,
                int ndraws, uint64_t seed) {
  std::mt19937_64 rng(seed);
  Draws d = draw_conditional_spins(chi_eff, q, a_max, ndraws, rng);

  double max_chi_p;
  const double lift = (1.0 + q) * std::fabs(chi_eff);
  if (lift / q < a_max) {
    max_chi_p = a_max;
  } else {
    const double t = lift - q;
    max_chi_p = std::sqrt(std::max(0.0, a_max * a_max - t * t));
  }

  double grid[kGrid];
  double vals[kGrid];
  grid[0] = 0.0;
  vals[0] = 0.0;
  for (int g = 0; g < kGridInterior; ++g) {
    grid[g + 1] = (0.05 + 0.90 * g / (kGridInterior - 1)) * max_chi_p;
  }
  grid[kGrid - 1] = max_chi_p;
  vals[kGrid - 1] = 0.0;
  weighted_kde_on_grid(d, grid + 1, kGridInterior, vals + 1);

  // trapezoid normalization
  double norm = 0.0;
  for (int g = 0; g + 1 < kGrid; ++g) {
    norm += 0.5 * (vals[g] + vals[g + 1]) * (grid[g + 1] - grid[g]);
  }
  if (norm <= 0.0) return 0.0;

  // linear interpolation at chi_p (0 outside [0, max_chi_p])
  if (chi_p <= grid[0]) return vals[0] / norm;
  if (chi_p >= grid[kGrid - 1]) return vals[kGrid - 1] / norm;
  int lo = 0;
  for (int g = 1; g < kGrid; ++g) {
    if (grid[g] >= chi_p) {
      lo = g - 1;
      break;
    }
  }
  const double t = (chi_p - grid[lo]) / (grid[lo + 1] - grid[lo]);
  return ((1.0 - t) * vals[lo] + t * vals[lo + 1]) / norm;
}

}  // namespace

extern "C" {

// Batched conditional prior: out[i] = p(chi_p[i] | chi_eff[i], q[i]).
// Parallelized over samples with OpenMP; each sample gets a deterministic
// per-index RNG stream derived from `seed`.
void chi_p_prior_batch(const double* chi_p, const double* chi_eff,
                       const double* q, int64_t n, double a_max, int ndraws,
                       uint64_t seed, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t i = 0; i < n; ++i) {
    out[i] = eval_one(chi_p[i], chi_eff[i], q[i], a_max, ndraws,
                      seed ^ (0x9E3779B97F4A7C15ULL * (uint64_t)(i + 1)));
  }
}

int chi_p_prior_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
