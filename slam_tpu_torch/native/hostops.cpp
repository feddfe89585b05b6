// Native host-side inner loops.
//
// The reference implements every per-descriptor host operation in C++
// (openvslam/match_base.h popcount distance, map_point.cpp medoid
// descriptor, feature_search.cpp radius search, random_array.cc seeded
// RANSAC index sampling). The TPU framework keeps its dense bulk work on
// the device; these are the residual host-side hot loops, exposed through a
// plain C ABI for ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC hostops.cpp -o libhostops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hamming distances over 256-bit descriptors stored as uint32[8]
// (reference: openvslam/match_base.h:18-39)
// ---------------------------------------------------------------------------

static inline int desc_distance(const uint32_t* a, const uint32_t* b) {
    // 4x 64-bit popcounts over the 256-bit descriptor (alignment of the
    // uint32[8] arrays is sufficient for unaligned 64-bit loads on x86)
    uint64_t wa, wb;
    int d = 0;
    for (int i = 0; i < 8; i += 2) {
        std::memcpy(&wa, a + i, 8);
        std::memcpy(&wb, b + i, 8);
        d += __builtin_popcountll(wa ^ wb);
    }
    return d;
}

// out[n*m] = hamming(a[i], b[j])
void hamming_matrix(const uint32_t* a, int64_t n, const uint32_t* b, int64_t m,
                    int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* ai = a + 8 * i;
        int32_t* row = out + m * i;
        for (int64_t j = 0; j < m; ++j) {
            row[j] = desc_distance(ai, b + 8 * j);
        }
    }
}

// out[m] = hamming(a, b[j]) for a single query descriptor
void hamming_row(const uint32_t* a, const uint32_t* b, int64_t m, int32_t* out) {
    for (int64_t j = 0; j < m; ++j) out[j] = desc_distance(a, b + 8 * j);
}

// out[i] = argmin_j hamming(a[i], b[j]) (first minimum), without
// materializing the n x m distance matrix (BoW quantization hot path).
void hamming_argmin(const uint32_t* a, int64_t n, const uint32_t* b, int64_t m,
                    int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* ai = a + 8 * i;
        int best = INT32_MAX;
        int64_t bj = 0;
        for (int64_t j = 0; j < m; ++j) {
            const int d = desc_distance(ai, b + 8 * j);
            if (d < best) { best = d; bj = j; }
        }
        out[i] = (int32_t)bj;
    }
}

// ---------------------------------------------------------------------------
// Medoid descriptor: index with the smallest median distance to the others
// (reference: map_point.cpp:75-116). Ties keep the first index (strict <).
// ---------------------------------------------------------------------------

int64_t medoid_descriptor(const uint32_t* descs, int64_t n) {
    if (n <= 0) return -1;
    if (n == 1) return 0;
    std::vector<int32_t> dist(n * n, 0);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i + 1; j < n; ++j) {
            int d = desc_distance(descs + 8 * i, descs + 8 * j);
            dist[i * n + j] = d;
            dist[j * n + i] = d;
        }
    }
    int64_t best_idx = 0;
    int32_t best_median = INT32_MAX;
    std::vector<int32_t> row(n);
    const int64_t mid = (int64_t)(0.5 * (n - 1));
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(row.data(), dist.data() + i * n, n * sizeof(int32_t));
        std::nth_element(row.begin(), row.begin() + mid, row.end());
        const int32_t median = row[mid];
        if (median < best_median) {
            best_median = median;
            best_idx = i;
        }
    }
    return best_idx;
}

// ---------------------------------------------------------------------------
// Radius search over y-sorted keypoints (reference: feature_search.cpp:33-48)
// xs/ys are sorted by ys ascending; returns number of hits written to out.
// ---------------------------------------------------------------------------

int64_t radius_search(const float* xs, const float* ys, int64_t n,
                      float qx, float qy, float r, int64_t* out) {
    const float* lo = std::lower_bound(ys, ys + n, qy - r);
    int64_t count = 0;
    const float r2 = r * r;
    for (int64_t i = lo - ys; i < n && ys[i] <= qy + r; ++i) {
        const float dx = qx - xs[i];
        const float dy = qy - ys[i];
        if (dx * dx + dy * dy < r2) out[count++] = i;
    }
    return count;
}

// ---------------------------------------------------------------------------
// Fused bucketed greedy matchers (reference: keyframe_matcher.cpp:50-293).
//
// These fuse what the Python path does in three passes (full NxM Hamming
// matrix, full NxM epipolar gate, Python greedy scan) into one pass that only
// touches same-vocabulary-group candidate pairs. Semantics are kept identical
// to ops/matching.py: iteration in (group, index) order on both sides, greedy
// one-to-one assignment, last-minimum tie-breaking for triangulation and
// first-minimum + Lowe ratio for loop closures. Epipolar math is double
// precision in the same operation order as the NumPy expression (dot first,
// then divide) so gates agree bit-for-bit (build uses -ffp-contract=off).
// ---------------------------------------------------------------------------

namespace {

// indices of set mask entries, stable-ordered by (group, index)
static std::vector<int64_t> bucket_order(const int32_t* groups,
                                         const uint8_t* mask, int64_t n) {
    std::vector<int64_t> idx;
    idx.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        if (mask[i]) idx.push_back(i);
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
        return groups[a] < groups[b];
    });
    return idx;
}

// group id -> [begin, end) range inside a bucket_order vector
struct GroupRanges {
    std::vector<int32_t> group;
    std::vector<int64_t> begin, end;
    int64_t find(int32_t g) const {
        auto it = std::lower_bound(group.begin(), group.end(), g);
        if (it == group.end() || *it != g) return -1;
        return it - group.begin();
    }
};

static GroupRanges group_ranges(const std::vector<int64_t>& order,
                                const int32_t* groups) {
    GroupRanges r;
    int64_t i = 0;
    const int64_t n = (int64_t)order.size();
    while (i < n) {
        int64_t j = i;
        const int32_t g = groups[order[i]];
        while (j < n && groups[order[j]] == g) ++j;
        r.group.push_back(g);
        r.begin.push_back(i);
        r.end.push_back(j);
        i = j;
    }
    return r;
}

}  // namespace

// Triangulation matching: same-group, both-free, dist<=thr_low, epipolar
// inlier; running minimum with LAST-candidate tie win; greedy one-to-one.
// bearings are double (n*3); E12 row-major 3x3; sin_thr1 per-kp1 gate.
void match_triangulation(
    const uint32_t* desc1, const int32_t* groups1, const uint8_t* free1,
    const double* bearings1, const double* sin_thr1, int64_t n1,
    const uint32_t* desc2, const int32_t* groups2, const uint8_t* free2,
    const double* bearings2, int64_t n2,
    const double* E12, int32_t thr_low, int64_t* matched) {
    for (int64_t i = 0; i < n1; ++i) matched[i] = -1;
    const std::vector<int64_t> order1 = bucket_order(groups1, free1, n1);
    const std::vector<int64_t> order2 = bucket_order(groups2, free2, n2);
    const GroupRanges ranges2 = group_ranges(order2, groups2);
    if (order1.empty() || order2.empty()) return;

    // epiplane normals in cam1 for side-2 candidates: ep_j = E12 @ b2_j
    std::vector<double> ep(order2.size() * 3), epnorm(order2.size());
    for (size_t k = 0; k < order2.size(); ++k) {
        const double* b = bearings2 + 3 * order2[k];
        double e0 = E12[0] * b[0] + E12[1] * b[1] + E12[2] * b[2];
        double e1 = E12[3] * b[0] + E12[4] * b[1] + E12[5] * b[2];
        double e2 = E12[6] * b[0] + E12[7] * b[1] + E12[8] * b[2];
        ep[3 * k] = e0; ep[3 * k + 1] = e1; ep[3 * k + 2] = e2;
        double nn = std::sqrt(e0 * e0 + e1 * e1 + e2 * e2);
        epnorm[k] = nn > 1e-12 ? nn : 1e-12;
    }

    std::vector<uint8_t> used2(n2, 0);
    for (const int64_t i : order1) {
        const int64_t gi = ranges2.find(groups1[i]);
        if (gi < 0) continue;
        const uint32_t* di = desc1 + 8 * i;
        const double* bi = bearings1 + 3 * i;
        const double gate = sin_thr1[i];
        int32_t best_d = thr_low;
        int64_t best = -1;
        for (int64_t k = ranges2.begin[gi]; k < ranges2.end[gi]; ++k) {
            const int64_t j = order2[k];
            if (used2[j]) continue;
            const int d = desc_distance(di, desc2 + 8 * j);
            if (d > thr_low) continue;
            const double cosr = (bi[0] * ep[3 * k] + bi[1] * ep[3 * k + 1] +
                                 bi[2] * ep[3 * k + 2]) / epnorm[k];
            if (!(cosr < gate)) continue;
            if (d <= best_d) { best_d = d; best = j; }
        }
        if (best >= 0) {
            matched[i] = best;
            used2[best] = 1;
        }
    }
}

// Loop-closure matching: same-group, both candidate, first-minimum wins ties,
// best<=thr_low and lowe_ratio*second-best < best rejects; greedy one-to-one.
void match_loop_closure(
    const uint32_t* desc1, const int32_t* groups1, const uint8_t* cand1,
    int64_t n1,
    const uint32_t* desc2, const int32_t* groups2, const uint8_t* cand2,
    int64_t n2,
    double lowe_ratio, int32_t thr_low, int32_t max_dist, int64_t* matched) {
    for (int64_t i = 0; i < n1; ++i) matched[i] = -1;
    const std::vector<int64_t> order1 = bucket_order(groups1, cand1, n1);
    const std::vector<int64_t> order2 = bucket_order(groups2, cand2, n2);
    const GroupRanges ranges2 = group_ranges(order2, groups2);
    if (order1.empty() || order2.empty()) return;

    std::vector<uint8_t> used2(n2, 0);
    for (const int64_t i : order1) {
        const int64_t gi = ranges2.find(groups1[i]);
        if (gi < 0) continue;
        const uint32_t* di = desc1 + 8 * i;
        int32_t best_d = max_dist + 1, second_d = max_dist;
        int64_t best = -1;
        for (int64_t k = ranges2.begin[gi]; k < ranges2.end[gi]; ++k) {
            const int64_t j = order2[k];
            if (used2[j]) continue;
            const int d = desc_distance(di, desc2 + 8 * j);
            if (d < best_d) {
                if (best >= 0) second_d = best_d;
                best_d = d;
                best = j;
            } else if (d < second_d) {
                second_d = d;
            }
        }
        if (best < 0 || best_d > thr_low) continue;
        if (lowe_ratio * (double)second_d < (double)best_d) continue;
        matched[i] = best;
        used2[best] = 1;
    }
}

// ---------------------------------------------------------------------------
// Fused radius search + Hamming argmin (projection-matcher inner loop:
// keyframe_matcher.cpp:416-529 / 552-631). For each query: keypoints strictly
// inside the circle (y-sorted scan, same order as radius_search), optional
// octave band filter, first-minimum Hamming distance. xs/ys are y-sorted;
// `order` maps sorted index -> original keypoint index; descriptors/octaves
// are in original order.
// ---------------------------------------------------------------------------

void radius_hamming_best(
    const float* xs, const float* ys, const int64_t* order, int64_t n,
    const uint32_t* descs, const int32_t* octaves,
    const float* qx, const float* qy, const float* qr,
    const uint32_t* qdesc, const int32_t* qlvl_min, const int32_t* qlvl_max,
    int64_t c, int64_t* best_idx, int32_t* best_dist) {
    for (int64_t q = 0; q < c; ++q) {
        const float r = qr[q], x = qx[q], y = qy[q];
        const float r2 = r * r;
        const float* lo = std::lower_bound(ys, ys + n, y - r);
        const uint32_t* qd = qdesc + 8 * q;
        const int32_t lmin = qlvl_min[q], lmax = qlvl_max[q];
        int32_t bd = INT32_MAX;
        int64_t bi = -1;
        for (int64_t i = lo - ys; i < n && ys[i] <= y + r; ++i) {
            const float dx = x - xs[i], dy = y - ys[i];
            if (dx * dx + dy * dy >= r2) continue;
            const int64_t oi = order[i];
            const int32_t lvl = octaves[oi];
            if (lvl < lmin || lvl > lmax) continue;
            const int d = desc_distance(qd, descs + 8 * oi);
            if (d < bd) { bd = d; bi = oi; }
        }
        best_idx[q] = bi;
        best_dist[q] = bd == INT32_MAX ? 256 : bd;
    }
}

// CSR-batched medoid scan: points[p] owns descriptors [ptr[p], ptr[p+1]).
// Same semantics as medoid_descriptor per segment; out[p] is the index
// WITHIN the segment (-1 for an empty segment).
void medoid_descriptor_many(const uint32_t* descs, const int64_t* ptr,
                            int64_t n_points, int64_t* out) {
    for (int64_t p = 0; p < n_points; ++p) {
        out[p] = medoid_descriptor(descs + 8 * ptr[p], ptr[p + 1] - ptr[p]);
    }
}

// ---------------------------------------------------------------------------
// Fused projection-matcher greedy claim (reference:
// keyframe_matcher.cpp:295-414 searchByProjection inner loop). For each query
// (a local map point already past the frustum/distance/viewing-cone gates, in
// input order): keypoints strictly inside the circle that are not yet owned,
// scanned in ORIGINAL INDEX order (matching the Python twin's np.where scan),
// best + second-best Hamming with their octaves, then the reference's accept
// rule (best <= thr_high; reject when best/second share an octave and
// best > lowe * second). Accepted queries claim the keypoint: ownership is
// updated sequentially, exactly like the reference's greedy loop.
// ---------------------------------------------------------------------------

void project_greedy_claim(
    const float* xs, const float* ys, const int64_t* order, int64_t n,
    const uint32_t* descs, const int32_t* octaves, uint8_t* owned,
    const float* qx, const float* qy, const float* qr,
    const uint32_t* qdesc, int64_t c,
    int32_t thr_high, double lowe, int64_t* matched) {
    std::vector<int64_t> hits;
    for (int64_t q = 0; q < c; ++q) {
        matched[q] = -1;
        const float r = qr[q], x = qx[q], y = qy[q];
        const float r2 = r * r;
        const float* lo = std::lower_bound(ys, ys + n, y - r);
        hits.clear();
        for (int64_t i = lo - ys; i < n && ys[i] <= y + r; ++i) {
            const float dx = x - xs[i], dy = y - ys[i];
            if (dx * dx + dy * dy < r2) {
                const int64_t oi = order[i];
                if (!owned[oi]) hits.push_back(oi);
            }
        }
        if (hits.empty()) continue;
        std::sort(hits.begin(), hits.end());  // original-index scan order
        const uint32_t* qd = qdesc + 8 * q;
        int32_t best_d = 256, second_d = 256, best_l = -1, second_l = -1;
        int64_t best = -1;
        for (const int64_t j : hits) {
            const int d = desc_distance(qd, descs + 8 * j);
            if (d < best_d) {
                second_d = best_d;
                second_l = best_l;
                best_d = d;
                best_l = octaves[j];
                best = j;
            } else if (d < second_d) {
                second_d = d;
                second_l = octaves[j];
            }
        }
        if (best < 0 || best_d > thr_high) continue;
        if (best_l == second_l && (double)best_d > lowe * (double)second_d)
            continue;
        matched[q] = best;
        owned[best] = 1;
    }
}

// ---------------------------------------------------------------------------
// Fused frame-to-frame tracker matching (DescriptorTracker._match_to_prev
// NumPy twin in frontends/descriptor_tracker.py). One pass over the pair
// grid replaces three dense host matrices (Hamming NxM, pixel-distance NxM,
// row argsort): per current-keypoint best + second-best Hamming within the
// motion radius, Lowe ratio + absolute threshold, and the mutual-best check
// via column minima accumulated in the same sweep. Scan order is ascending
// index with strict '<' so best/back agree exactly with the NumPy
// argsort/argmin (first-minimum) semantics.
// ---------------------------------------------------------------------------

void match_tracker(
    const uint32_t* desc1, const float* pts1, int64_t n1,   // current frame
    const uint32_t* desc2, const float* pts2, int64_t n2,   // previous frame
    double max_motion, int32_t thr, double lowe, int64_t* best_out) {
    const float r2 = (float)(max_motion * max_motion);
    // column minima over gated rows; NumPy argmin over an all-masked (10000)
    // column returns 0, so initialize col_bi to 0
    std::vector<int32_t> col_bd(n2, INT32_MAX);
    std::vector<int64_t> col_bi(n2, 0);
    std::vector<int32_t> row_bd(n1), row_sd(n1);
    std::vector<int64_t> row_bj(n1, -1);
    for (int64_t i = 0; i < n1; ++i) {
        const uint32_t* di = desc1 + 8 * i;
        const float xi = pts1[2 * i], yi = pts1[2 * i + 1];
        // ungated entries carry the mask value 10000 in the NumPy twin, so
        // with >1 previous keypoints the second-best floor is 10000 (256
        // when there is only one column, mirroring the twin's edge case)
        int32_t bd = INT32_MAX, sd = n2 > 1 ? 10000 : 256;
        int64_t bj = -1;
        for (int64_t j = 0; j < n2; ++j) {
            const float dx = xi - pts2[2 * j], dy = yi - pts2[2 * j + 1];
            if (dx * dx + dy * dy > r2) continue;
            const int d = desc_distance(di, desc2 + 8 * j);
            if (d < bd) {
                if (bj >= 0) sd = bd;
                bd = d;
                bj = j;
            } else if (d < sd) {
                sd = d;
            }
            if (d < col_bd[j]) { col_bd[j] = d; col_bi[j] = i; }
        }
        row_bd[i] = bd;
        row_sd[i] = sd;
        row_bj[i] = bj;
    }
    for (int64_t i = 0; i < n1; ++i) {
        const int64_t j = row_bj[i];
        const bool ok = j >= 0 && row_bd[i] <= thr &&
                        (double)row_bd[i] < lowe * (double)row_sd[i] &&
                        col_bi[j] == i;
        best_out[i] = ok ? j : -1;
    }
}

// ---------------------------------------------------------------------------
// Fused two-view triangulation for fresh map points
// (reference: mapper_helpers.cpp:600-722 in the 2-observation form used by
// createNewMapPoints, :271-318). Native twin of
// pipeline/mapper_helpers._batch_triangulate_pairs: depth seeding from the
// first positive-depth observation in KfId order (adjacent first), the
// two-ray angle gate, two-view DLT via the smallest right-singular vector,
// and positive-depth + octave-scaled chi2 reprojection gates on BOTH frames.
// All math in double precision with the same operation order as the NumPy
// twin (-ffp-contract=off build) so gate decisions agree.
// ---------------------------------------------------------------------------

namespace {

// Packed camera parameters: [kind, fx, fy, cx, cy, d0, d1, d2, d3,
//                            width, height, focal]
// kind 0 = pinhole (+ optional radtan k1,k2,p1,p2), 1 = Kannala-Brandt
// (k1..k4). `focal` is the integer image-scale proxy
// (geometry/camera.py get_focal_length).
struct CamPack {
    int kind;
    double fx, fy, cx, cy;
    double d[4];
    double width, height, focal;
};

static CamPack unpack_camera(const double* p) {
    CamPack c;
    c.kind = (int)p[0];
    c.fx = p[1]; c.fy = p[2]; c.cx = p[3]; c.cy = p[4];
    c.d[0] = p[5]; c.d[1] = p[6]; c.d[2] = p[7]; c.d[3] = p[8];
    c.width = p[9]; c.height = p[10]; c.focal = p[11];
    return c;
}

// geometry/camera.py ray_to_pixel (PinholeCamera:109-118 /
// KannalaBrandtCamera:165-175), identical formulas and operation order.
static bool ray_to_pixel(const CamPack& c, const double* ray,
                         double* u, double* v) {
    if (c.kind == 0) {
        const double z = ray[2];
        const bool valid = z > 1e-9;
        const double zsafe = valid ? z : 1.0;
        const double xn = ray[0] / zsafe;
        const double yn = ray[1] / zsafe;
        double xd = xn, yd = yn;
        if (c.d[0] != 0.0 || c.d[1] != 0.0 || c.d[2] != 0.0 || c.d[3] != 0.0) {
            const double k1 = c.d[0], k2 = c.d[1], p1 = c.d[2], p2 = c.d[3];
            const double r2 = xn * xn + yn * yn;
            const double radial = 1.0 + k1 * r2 + k2 * r2 * r2;
            xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn);
            yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn;
        }
        *u = c.fx * xd + c.cx;
        *v = c.fy * yd + c.cy;
        return valid;
    }
    // Kannala-Brandt equidistant fisheye
    const double x = ray[0], y = ray[1], z = ray[2];
    const double r = std::hypot(x, y);
    const double theta = std::atan2(r, z);
    const bool valid = theta < 1.7453292519943295;  // radians(100.0)
    const double t2 = theta * theta;
    const double theta_d = theta * (1.0 + t2 * (c.d[0] + t2 * (c.d[1] +
                                    t2 * (c.d[2] + t2 * c.d[3]))));
    const double scale =
        r > 1e-12 ? theta_d / (r > 1e-12 ? r : 1e-12) : 1.0;
    *u = c.fx * x * scale + c.cx;
    *v = c.fy * y * scale + c.cy;
    return valid;
}

static inline bool pixel_in_image(const CamPack& c, double u, double v) {
    return u >= 0.0 && v >= 0.0 && u < c.width && v < c.height;
}

// Eigenvector of the smallest eigenvalue of the symmetric 4x4 matrix S
// (= smallest right-singular vector of A when S = A^T A), via cyclic Jacobi.
static void min_eigvec4(double S[4][4], double* out) {
    double V[4][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}};
    for (int sweep = 0; sweep < 32; ++sweep) {
        double off = 0.0;
        for (int p = 0; p < 4; ++p)
            for (int q = p + 1; q < 4; ++q) off += S[p][q] * S[p][q];
        if (off < 1e-26) break;
        for (int p = 0; p < 4; ++p) {
            for (int q = p + 1; q < 4; ++q) {
                const double apq = S[p][q];
                if (std::abs(apq) < 1e-300) continue;
                const double tau = (S[q][q] - S[p][p]) / (2.0 * apq);
                const double t = (tau >= 0 ? 1.0 : -1.0) /
                                 (std::abs(tau) + std::sqrt(1.0 + tau * tau));
                const double cth = 1.0 / std::sqrt(1.0 + t * t);
                const double sth = t * cth;
                for (int k = 0; k < 4; ++k) {
                    const double skp = S[k][p], skq = S[k][q];
                    S[k][p] = cth * skp - sth * skq;
                    S[k][q] = sth * skp + cth * skq;
                }
                for (int k = 0; k < 4; ++k) {
                    const double spk = S[p][k], sqk = S[q][k];
                    S[p][k] = cth * spk - sth * sqk;
                    S[q][k] = sth * spk + cth * sqk;
                    const double vkp = V[k][p], vkq = V[k][q];
                    V[k][p] = cth * vkp - sth * vkq;
                    V[k][q] = sth * vkp + cth * vkq;
                }
            }
        }
    }
    int best = 0;
    for (int i = 1; i < 4; ++i)
        if (S[i][i] < S[best][best]) best = i;
    for (int k = 0; k < 4; ++k) out[k] = V[k][best];
}

// One keyframe side of the triangulation problem.
struct TriFrame {
    const double* pose;    // 3x4 row-major poseCW
    const double* bear;    // n x 3 camera-frame bearings
    const float* depth;    // n
    const double* npix;    // n x 2 normalized pixels
    const uint8_t* nok;    // n normalized-pixel validity
    const float* pts;      // n x 2
    const int32_t* oct;    // n
    CamPack cam;
    double Rwc[3][3];      // camera-to-world rotation = poseCW[:3,:3]^T
    double center[3];      // camera center -R^T t

    void init() {
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) Rwc[i][j] = pose[4 * j + i];
        for (int i = 0; i < 3; ++i) {
            center[i] = -(Rwc[i][0] * pose[3] + Rwc[i][1] * pose[7] +
                          Rwc[i][2] * pose[11]);
        }
    }
    void world_ray(int64_t kp, double* out) const {
        const double* b = bear + 3 * kp;
        for (int i = 0; i < 3; ++i)
            out[i] = Rwc[i][0] * b[0] + Rwc[i][1] * b[1] + Rwc[i][2] * b[2];
    }
    // positive-depth + in-image + octave-scaled chi2 gate for world point X
    // (same formulas as the NumPy twin's per-frame gate block)
    bool gates_ok(const double* X, int64_t kp, const double* sigma2_rel,
                  double rel_thr, double chi2) const {
        const double z = pose[8] * X[0] + pose[9] * X[1] + pose[10] * X[2] +
                         pose[11];
        if (!(z > 0.0)) return false;
        double pc[3];
        for (int i = 0; i < 3; ++i)
            pc[i] = pose[4 * i] * X[0] + pose[4 * i + 1] * X[1] +
                    pose[4 * i + 2] * X[2] + pose[4 * i + 3];
        double u, vv;
        if (!ray_to_pixel(cam, pc, &u, &vv)) return false;
        if (!pixel_in_image(cam, u, vv)) return false;
        const double rel = cam.focal * rel_thr;
        const double sigma2 = sigma2_rel[oct[kp]] * rel * rel;
        const double du = u - (double)pts[2 * kp];
        const double dv = vv - (double)pts[2 * kp + 1];
        const double err = du * du + dv * dv;
        return err <= chi2 * sigma2;
    }
};

}  // namespace

// kp_cur/kp_adj: B matched keypoint index pairs (current, adjacent).
// Outputs: pos_out (B x 3) world positions, ok_out (B) acceptance.
void triangulate_pairs(
    const int64_t* kp_cur, const int64_t* kp_adj, int64_t B,
    const double* pose_c, const double* bear_c, const float* depth_c,
    const double* npix_c, const uint8_t* nok_c, const float* pts_c,
    const int32_t* oct_c, const double* cam_c,
    const double* pose_a, const double* bear_a, const float* depth_a,
    const double* npix_a, const uint8_t* nok_a, const float* pts_a,
    const int32_t* oct_a, const double* cam_a,
    double cos_min, const double* sigma2_rel,
    double rel_thr, double chi2,
    double* pos_out, uint8_t* ok_out) {
    TriFrame cur{pose_c, bear_c, depth_c, npix_c, nok_c, pts_c, oct_c,
                 unpack_camera(cam_c), {}, {}};
    TriFrame adj{pose_a, bear_a, depth_a, npix_a, nok_a, pts_a, oct_a,
                 unpack_camera(cam_a), {}, {}};
    cur.init();
    adj.init();

    for (int64_t r = 0; r < B; ++r) {
        const int64_t kc = kp_cur[r], ka = kp_adj[r];
        double* X = pos_out + 3 * r;
        X[0] = X[1] = X[2] = 0.0;
        bool ok;
        double ray_a[3], ray_c[3];
        adj.world_ray(ka, ray_a);
        cur.world_ray(kc, ray_c);
        const double da = (double)depth_a[ka];
        const double dc = (double)depth_c[kc];
        if (da > 0.0) {
            // depth seeding: first positive depth in observation (KfId) order
            for (int i = 0; i < 3; ++i) X[i] = da * ray_a[i] + adj.center[i];
            ok = true;
        } else if (dc > 0.0) {
            for (int i = 0; i < 3; ++i) X[i] = dc * ray_c[i] + cur.center[i];
            ok = true;
        } else {
            // two-ray angle gate on unit world rays
            const double na = std::max(std::sqrt(ray_a[0] * ray_a[0] +
                ray_a[1] * ray_a[1] + ray_a[2] * ray_a[2]), 1e-12);
            const double nc = std::max(std::sqrt(ray_c[0] * ray_c[0] +
                ray_c[1] * ray_c[1] + ray_c[2] * ray_c[2]), 1e-12);
            const double dot = (ray_a[0] / na) * (ray_c[0] / nc) +
                               (ray_a[1] / na) * (ray_c[1] / nc) +
                               (ray_a[2] / na) * (ray_c[2] / nc);
            // DLT design rows: n.x * P[2] - P[0], n.y * P[2] - P[1] per frame
            double A[4][4];
            const double nax = npix_a[2 * ka], nay = npix_a[2 * ka + 1];
            const double ncx = npix_c[2 * kc], ncy = npix_c[2 * kc + 1];
            for (int j = 0; j < 4; ++j) {
                A[0][j] = nax * pose_a[8 + j] - pose_a[j];
                A[1][j] = nay * pose_a[8 + j] - pose_a[4 + j];
                A[2][j] = ncx * pose_c[8 + j] - pose_c[j];
                A[3][j] = ncy * pose_c[8 + j] - pose_c[4 + j];
            }
            double S[4][4];
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 4; ++j) {
                    double s = 0.0;
                    for (int k = 0; k < 4; ++k) s += A[k][i] * A[k][j];
                    S[i][j] = s;
                }
            double Xh[4];
            min_eigvec4(S, Xh);
            const bool nonzero = std::abs(Xh[3]) > 1e-12;
            if (nonzero)
                for (int i = 0; i < 3; ++i) X[i] = Xh[i] / Xh[3];
            ok = (dot < cos_min) && nok_a[ka] && nok_c[kc] && nonzero;
        }
        ok = ok && adj.gates_ok(X, ka, sigma2_rel, rel_thr, chi2);
        ok = ok && cur.gates_ok(X, kc, sigma2_rel, rel_thr, chi2);
        ok_out[r] = ok ? 1 : 0;
    }
}

// Fused per-adjacent-pair stage of createNewMapPoints
// (mapper_helpers.cpp:271-318): essential matrix + per-keypoint epipolar
// thresholds, epipolar-gated greedy matching (match_triangulation), the
// rotation-consistency histogram vote (match_angle_checker.h:72-123), and
// gated two-view triangulation (triangulate_pairs) in ONE host call — the
// per-pair NumPy glue costs more wall time than the matching itself at
// ~10 adjacent keyframes per backend keyframe. NumPy twin: the
// match_for_triangulation + apply_angle_check + triangulate path in
// pipeline/matcher.py / mapper_helpers.py (kept in lockstep by the
// cross-check test in tests/test_native_and_misc.py).
// Returns the surviving match count B; kp_cur/kp_adj/pos_out/ok_out are
// filled for rows [0, B) (capacity n1).
int64_t match_triangulate_pair(
    const uint32_t* desc1, const int32_t* groups1, const uint8_t* free1,
    const double* bearings1, const float* angles1, const int32_t* oct1,
    int64_t n1,
    const uint32_t* desc2, const int32_t* groups2, const uint8_t* free2,
    const double* bearings2, const float* angles2, int64_t n2,
    const double* pose1, const double* pose2,   // 3x4 world->camera, f64
    const double* scale_factors, int64_t n_levels,
    double epi_thr_deg, int32_t thr_low,
    const float* depth1, const double* npix1, const uint8_t* nok1,
    const float* pts1, const double* cam1,
    const float* depth2, const double* npix2, const uint8_t* nok2,
    const float* pts2, const int32_t* oct2, const double* cam2,
    double cos_min, const double* sigma2_rel, double rel_thr, double chi2,
    int64_t* kp_cur, int64_t* kp_adj, double* pos_out, uint8_t* ok_out) {
    // E12 = skew(t21) @ rot21 with rot21 = R1 R2^T, t21 = -rot21 t2 + t1
    // (matcher.py:104 argument order into create_E_21; same summation
    // order as the NumPy matmuls, -ffp-contract=off build keeps parity)
    const double* R1 = pose1;          // rows 0..2, cols 0..2; col 3 = t
    const double* R2 = pose2;
    double rot21[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0.0;
            for (int k = 0; k < 3; ++k)
                s += R1[4 * i + k] * R2[4 * j + k];
            rot21[3 * i + j] = s;
        }
    double t21[3];
    for (int i = 0; i < 3; ++i) {
        double s = 0.0;
        for (int k = 0; k < 3; ++k) s += rot21[3 * i + k] * pose2[4 * k + 3];
        t21[i] = -s + pose1[4 * i + 3];
    }
    double skewm[9] = {0.0, -t21[2], t21[1],
                       t21[2], 0.0, -t21[0],
                       -t21[1], t21[0], 0.0};
    double E12[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0.0;
            for (int k = 0; k < 3; ++k) s += skewm[3 * i + k] * rot21[3 * k + j];
            E12[3 * i + j] = s;
        }

    // per-keypoint epipolar gate: sin(radians(thr_deg) * scaleFactor[oct])
    // (matcher.py:112-113; same op order: radians first, then * scale)
    const double rad = epi_thr_deg * (3.141592653589793238462643383279502884 / 180.0);
    std::vector<double> sin_thr(n1);
    for (int64_t i = 0; i < n1; ++i) {
        int64_t o = oct1[i];
        if (o < 0) o = 0;
        if (o > n_levels - 1) o = n_levels - 1;
        sin_thr[i] = std::sin(rad * scale_factors[o]);
    }

    std::vector<int64_t> matched(n1);
    match_triangulation(desc1, groups1, free1, bearings1, sin_thr.data(), n1,
                        desc2, groups2, free2, bearings2, n2,
                        E12, thr_low, matched.data());

    // rotation-consistency vote (ops/matching.angle_check_invalid):
    // bin = rint(delta * (1/30)) over delta wrapped to [0, 360) — round
    // half-to-even like np.rint — keep the 3 most-populated of 30 bins
    // (stable ties: smaller bin id wins)
    int64_t counts[30] = {0};
    std::vector<int> bins(n1, -1);
    for (int64_t i = 0; i < n1; ++i) {
        if (matched[i] < 0) continue;
        double d = (double)(angles1[i] - angles2[matched[i]]);  // f32 sub
        if (d < 0.0) d += 360.0;
        if (d >= 360.0) d -= 360.0;
        int b = (int)std::nearbyint(d * (1.0 / 30.0));
        if (b < 0) b = 0;
        if (b > 29) b = 29;
        bins[i] = b;
        counts[b]++;
    }
    int order[30];
    for (int b = 0; b < 30; ++b) order[b] = b;
    std::stable_sort(order, order + 30,
                     [&](int a, int b) { return counts[a] > counts[b]; });
    bool keep[30] = {false};
    for (int k = 0; k < 3; ++k) keep[order[k]] = true;

    int64_t B = 0;
    for (int64_t i = 0; i < n1; ++i) {
        if (matched[i] < 0 || !keep[bins[i]]) continue;
        kp_cur[B] = i;
        kp_adj[B] = matched[i];
        ++B;
    }
    if (B > 0)
        triangulate_pairs(kp_cur, kp_adj, B,
                          pose1, bearings1, depth1, npix1, nok1, pts1, oct1,
                          cam1,
                          pose2, bearings2, depth2, npix2, nok2, pts2, oct2,
                          cam2,
                          cos_min, sigma2_rel, rel_thr, chi2,
                          pos_out, ok_out);
    return B;
}

// ---------------------------------------------------------------------------
// Deterministic unique random index arrays (reference: random_array.cc:21-62)
// Thread-local MT19937 with the reference's fixed seed.
// ---------------------------------------------------------------------------

static thread_local std::mt19937 g_rng(94235682);

void seed_random(uint32_t seed) { g_rng.seed(seed); }

// n unique random ints in [lo, hi], shuffled (reference semantics)
void create_random_array(int64_t n, int32_t lo, int32_t hi, int32_t* out) {
    std::uniform_int_distribution<int32_t> dist(lo, hi);
    std::vector<int32_t> vals;
    vals.reserve(n);
    while ((int64_t)vals.size() < n) {
        int32_t v = dist(g_rng);
        bool dup = false;
        for (int32_t u : vals) {
            if (u == v) { dup = true; break; }
        }
        if (!dup) vals.push_back(v);
    }
    std::memcpy(out, vals.data(), n * sizeof(int32_t));
}

}  // extern "C"
