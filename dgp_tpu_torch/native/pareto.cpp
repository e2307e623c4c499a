// Native Pareto utilities for large Bayesian-optimization archives (the
// port's copy of dgp_tpu/native/pareto.cpp).
//
// The non-dominated sort of bo/ehvi.py (_ndc_numpy) is an O(n^2) Python
// double loop that becomes the host-side bottleneck of the BO loop once the
// archive grows to thousands of points (the card only sees the model math).
// This implements the same 2-objective minimization semantics in C++:
//
//   nd_sort_2d:  feasibility-filtered non-dominated indices, obj1-ascending,
//                O(n log n) (sort + sweep) instead of O(n^2).
//   hv_2d:       staircase dominated hypervolume w.r.t. an upper corner.
//
// Exposed with C linkage for ctypes; dgp_tpu_torch/native/__init__.py builds
// it with g++ on first use.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// y: [n, 2] row-major objectives; feasible: [n] 0/1; out: [n] index buffer.
// Returns the number of non-dominated feasible points written to out
// (sorted ascending by objective 1; ties resolved by objective 2, matching
// the strict-dominance definition of the reference).
int64_t nd_sort_2d(const double* y, int64_t n, const uint8_t* feasible,
                   int64_t* out) {
    std::vector<int64_t> idx;
    idx.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        if (feasible[i]) idx.push_back(i);
    }
    if (idx.empty()) return 0;
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
        if (y[2 * a] != y[2 * b]) return y[2 * a] < y[2 * b];
        return y[2 * a + 1] < y[2 * b + 1];
    });
    // sweep: a point is non-dominated iff its y2 is strictly below every
    // earlier (smaller-y1) point's y2; equal (y1, y2) duplicates are all
    // non-dominated under strict dominance.
    int64_t count = 0;
    double best_y2 = 0.0;
    bool have_best = false;
    double dup_y1 = 0.0, dup_y2 = 0.0;
    for (size_t k = 0; k < idx.size(); ++k) {
        const int64_t i = idx[k];
        const double y1 = y[2 * i], y2 = y[2 * i + 1];
        bool keep;
        if (!have_best) {
            keep = true;
        } else if (y1 == dup_y1 && y2 == dup_y2) {
            keep = true;  // exact duplicate of the previous kept point
        } else {
            keep = y2 < best_y2;
        }
        if (keep) {
            out[count++] = i;
            if (!have_best || y2 < best_y2) best_y2 = y2;
            have_best = true;
            dup_y1 = y1;
            dup_y2 = y2;
        }
    }
    return count;
}

// nd: obj1-ascending non-dominated indices (from nd_sort_2d); returns the
// dominated hypervolume w.r.t. the upper reference corner (u1, u2)
// (minimization; points beyond the corner contribute nothing).
double hv_2d(const double* y, const int64_t* nd, int64_t n_nd, double u1,
             double u2) {
    double hv = 0.0;
    double prev_y2 = u2;
    for (int64_t k = 0; k < n_nd; ++k) {
        const int64_t i = nd[k];
        const double y1 = y[2 * i], y2 = y[2 * i + 1];
        if (y1 > u1 || y2 >= prev_y2) continue;
        const double top = prev_y2 < u2 ? prev_y2 : u2;
        if (y2 < top) {
            hv += (u1 - y1) * (top - y2);
            prev_y2 = y2;
        }
    }
    return hv;
}

}  // extern "C"
