// Native single-core scan step: the honest CPU baseline.
//
// One LiDAR frame through the reference's hot path in plain C++ (reference:
// src/app/localization/pcm_matching/src/pcm_matching.cpp:198-299 range gate /
// deskew / downsample, registration.cpp:273-418 RunRegister with the P2P
// solver registration.cpp:15-66, correspondence voxel_hash_map.cpp:31-88),
// single-threaded (the reference runs the same math under <=10 TBB threads).
// Consumes the SAME packed map arrays as the device grid (table + fingerprint +
// per-voxel point blocks) so the comparison is math-for-math.
//
// Exposed as a C ABI via ctypes (elimaloc_tpu/map/native_builder.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

inline uint32_t mix_coords(int64_t x, int64_t y, int64_t z, uint32_t seed) {
    // identical to builder._mix_coords / grid._mix
    uint32_t h = seed ^ (static_cast<uint32_t>(x) * 0x85EBCA6Bu);
    h = (h ^ (h >> 13)) * 0xC2B2AE35u;
    h = h ^ (static_cast<uint32_t>(y) * 0x27D4EB2Fu);
    h = (h ^ (h >> 13)) * 0x165667B1u;
    h = h ^ (static_cast<uint32_t>(z) * 0x9E3779B1u);
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    h *= 0x846CA68Bu;
    h ^= h >> 16;
    return h;
}

struct GridView {
    const int32_t* table;      // [table_size + max_probe]
    const uint32_t* table_fp;  // same length
    const float* points;       // [(V+1) * M * 3], +inf padded
    int64_t table_size;
    int64_t max_probe;
    int64_t m;  // max points per voxel
    int64_t sentinel;
    double voxel_size;

    int64_t lookup(int64_t kx, int64_t ky, int64_t kz) const {
        uint32_t h = mix_coords(kx, ky, kz, 0x9E3779B1u) &
                     static_cast<uint32_t>(table_size - 1);
        uint32_t fp = mix_coords(kx, ky, kz, 0x51ED270Bu);
        if (fp == 0u) fp = 1u;
        for (int64_t p = 0; p < max_probe; ++p) {
            int32_t row = table[h + p];
            if (row < 0) return sentinel;  // empty before hit
            if (table_fp[h + p] == fp) return row;
        }
        return sentinel;
    }

    // nearest map point in the 27-voxel cube (voxel_hash_map.cpp:31-88)
    bool nearest(const double* q, double max_d2, double* out) const {
        const int64_t kx = static_cast<int64_t>(std::floor(q[0] / voxel_size));
        const int64_t ky = static_cast<int64_t>(std::floor(q[1] / voxel_size));
        const int64_t kz = static_cast<int64_t>(std::floor(q[2] / voxel_size));
        double best_d2 = max_d2;
        bool found = false;
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    int64_t row = lookup(kx + dx, ky + dy, kz + dz);
                    if (row == sentinel) continue;
                    const float* blk = points + row * m * 3;
                    for (int64_t i = 0; i < m; ++i) {
                        const float px = blk[3 * i];
                        if (!std::isfinite(px)) break;  // packed prefix
                        const double ddx = px - q[0];
                        const double ddy = blk[3 * i + 1] - q[1];
                        const double ddz = blk[3 * i + 2] - q[2];
                        const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 < best_d2) {
                            best_d2 = d2;
                            out[0] = px;
                            out[1] = blk[3 * i + 1];
                            out[2] = blk[3 * i + 2];
                            found = true;
                        }
                    }
                }
        return found;
    }
};

inline uint64_t pack_key(int64_t x, int64_t y, int64_t z) {
    const uint64_t b = 1ull << 20;
    return ((static_cast<uint64_t>(x + b) & 0x1fffffull) << 42) |
           ((static_cast<uint64_t>(y + b) & 0x1fffffull) << 21) |
           (static_cast<uint64_t>(z + b) & 0x1fffffull);
}

void mat3_from_rpy(const double r, const double p, const double y,
                   double R[9]) {
    const double cr = std::cos(r), sr = std::sin(r);
    const double cp = std::cos(p), sp = std::sin(p);
    const double cy = std::cos(y), sy = std::sin(y);
    R[0] = cy * cp; R[1] = cy * sp * sr - sy * cr; R[2] = cy * sp * cr + sy * sr;
    R[3] = sy * cp; R[4] = sy * sp * sr + cy * cr; R[5] = sy * sp * cr - cy * sr;
    R[6] = -sp;     R[7] = cp * sr;                R[8] = cp * cr;
}

void exp_so3(const double v[3], double R[9]) {
    // identity below 1e-5: the reference Exp's threshold (hpp:412-414)
    const double th = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    if (th < 1e-5) {
        R[0] = R[4] = R[8] = 1.0;
        R[1] = R[2] = R[3] = R[5] = R[6] = R[7] = 0.0;
        return;
    }
    const double ax = v[0] / th, ay = v[1] / th, az = v[2] / th;
    const double c = std::cos(th), s = std::sin(th), t = 1.0 - c;
    R[0] = c + ax * ax * t;      R[1] = ax * ay * t - az * s; R[2] = ax * az * t + ay * s;
    R[3] = ax * ay * t + az * s; R[4] = c + ay * ay * t;      R[5] = ay * az * t - ax * s;
    R[6] = ax * az * t - ay * s; R[7] = ay * az * t + ax * s; R[8] = c + az * az * t;
}

// 6x6 LDLT-free solve via Gaussian elimination with partial pivoting
bool solve6(double A[36], double b[6], double x[6]) {
    for (int col = 0; col < 6; ++col) {
        int best = col;
        for (int r = col + 1; r < 6; ++r)
            if (std::fabs(A[6 * r + col]) > std::fabs(A[6 * best + col]))
                best = r;
        if (best != col) {
            for (int c = 0; c < 6; ++c) std::swap(A[6 * col + c], A[6 * best + c]);
            std::swap(b[col], b[best]);
        }
        const double d = A[6 * col + col];
        if (std::fabs(d) < 1e-30) return false;
        for (int r = col + 1; r < 6; ++r) {
            const double f = A[6 * r + col] / d;
            if (f == 0.0) continue;
            for (int c = col; c < 6; ++c) A[6 * r + c] -= f * A[6 * col + c];
            b[r] -= f * b[col];
        }
    }
    for (int r = 5; r >= 0; --r) {
        double s = b[r];
        for (int c = r + 1; c < 6; ++c) s -= A[6 * r + c] * x[c];
        x[r] = s / A[6 * r + r];
    }
    return true;
}

// range gate -> deskew -> first-per-voxel downsample; returns ds points
int64_t preprocess_scan(const double* pts, const double* rel_times,
                        int64_t n_pts, const double* imu_t,
                        const double* imu_gyro, int64_t n_imu,
                        double scan_cur, double scan_end,
                        const double* odom_incre, double max_range,
                        double ds_voxel, std::vector<double>& ds) {
    // 1. range gate (pcm_matching.cpp:451-465)
    std::vector<double> p;
    std::vector<double> rel;
    p.reserve(3 * n_pts);
    rel.reserve(n_pts);
    for (int64_t i = 0; i < n_pts; ++i) {
        const double* q = pts + 3 * i;
        const double d = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
        if (d <= max_range) {
            p.push_back(q[0]);
            p.push_back(q[1]);
            p.push_back(q[2]);
            rel.push_back(rel_times[i]);
        }
    }
    int64_t n = static_cast<int64_t>(rel.size());
    if (n == 0) return 0;

    // 2. deskew to scan end (pcm_matching.cpp:533-824): integrate gyro over
    // the window, linear-interp per point, linear translation ratio
    std::vector<double> win_t, win_rot;
    {
        double rx = 0.0, ry = 0.0, rz = 0.0;
        double prev = 0.0;
        bool first = true;
        for (int64_t i = 0; i < n_imu; ++i) {
            const double t = imu_t[i];
            if (t < scan_cur - 0.01 || t > scan_end + 0.01) continue;
            if (!first) {
                const double dt = t - prev;
                rx += imu_gyro[3 * i] * dt;
                ry += imu_gyro[3 * i + 1] * dt;
                rz += imu_gyro[3 * i + 2] * dt;
            }
            first = false;
            prev = t;
            win_t.push_back(t);
            win_rot.push_back(rx);
            win_rot.push_back(ry);
            win_rot.push_back(rz);
        }
    }
    const int64_t nw = static_cast<int64_t>(win_t.size());
    if (nw >= 2) {
        const double span = std::max(scan_end - scan_cur, 1e-9);
        const double* rot_end = &win_rot[3 * (nw - 1)];
        for (int64_t i = 0; i < n; ++i) {
            const double pt_t = scan_cur + rel[i];
            // FindRotation: bracketing linear interpolation (cpp:731-762)
            int64_t f = 0;
            while (f < nw && win_t[f] <= pt_t) ++f;
            double rc[3];
            if (f >= nw) {
                rc[0] = win_rot[3 * (nw - 1)];
                rc[1] = win_rot[3 * (nw - 1) + 1];
                rc[2] = win_rot[3 * (nw - 1) + 2];
            } else if (f == 0) {
                rc[0] = win_rot[0];
                rc[1] = win_rot[1];
                rc[2] = win_rot[2];
            } else {
                const double ratio =
                    (pt_t - win_t[f - 1]) / (win_t[f] - win_t[f - 1]);
                for (int k = 0; k < 3; ++k)
                    rc[k] = win_rot[3 * f + k] * ratio +
                            win_rot[3 * (f - 1) + k] * (1.0 - ratio);
            }
            const double rfe[3] = {rc[0] - rot_end[0], rc[1] - rot_end[1],
                                   rc[2] - rot_end[2]};
            double R[9];
            mat3_from_rpy(rfe[0], rfe[1], rfe[2], R);
            const double ratio = rel[i] / span;
            double* q = &p[3 * i];
            const double x = q[0], y = q[1], z = q[2];
            q[0] = R[0] * x + R[1] * y + R[2] * z + (ratio - 1.0) * odom_incre[0];
            q[1] = R[3] * x + R[4] * y + R[5] * z + (ratio - 1.0) * odom_incre[1];
            q[2] = R[6] * x + R[7] * y + R[8] * z + (ratio - 1.0) * odom_incre[2];
        }
    }

    // 3. voxel downsample: first point per voxel (voxel_hash_map.hpp:260-283)
    std::unordered_set<uint64_t> seen;
    seen.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        const double* q = &p[3 * i];
        const uint64_t key = pack_key(
            static_cast<int64_t>(std::floor(q[0] / ds_voxel)),
            static_cast<int64_t>(std::floor(q[1] / ds_voxel)),
            static_cast<int64_t>(std::floor(q[2] / ds_voxel)));
        if (seen.insert(key).second) {
            ds.push_back(q[0]);
            ds.push_back(q[1]);
            ds.push_back(q[2]);
        }
    }
    return static_cast<int64_t>(ds.size() / 3);
}

}  // namespace

extern "C" {

// Preprocessing only (for equivalence tests): writes ds points into out
// (capacity cap*3); returns the count or -1 on overflow.
int64_t elm_preprocess_scan(const double* pts, const double* rel_times,
                            int64_t n_pts, const double* imu_t,
                            const double* imu_gyro, int64_t n_imu,
                            double scan_cur, double scan_end,
                            const double* odom_incre, double max_range,
                            double ds_voxel, double* out, int64_t cap) {
    std::vector<double> ds;
    int64_t nd = preprocess_scan(pts, rel_times, n_pts, imu_t, imu_gyro,
                                 n_imu, scan_cur, scan_end, odom_incre,
                                 max_range, ds_voxel, ds);
    if (nd > cap) return -1;
    std::memcpy(out, ds.data(), ds.size() * sizeof(double));
    return nd;
}

// Full single-core per-scan step: range gate -> deskew -> voxel downsample ->
// P2P Gauss-Newton/LM ICP. Mirrors elimaloc_tpu.reference_cpu.cpu_scan_step.
//
// Returns 1 on ICP success, 0 on gate failure, -1 on bad input.
// io_pose: [16] row-major 4x4, initial guess in, refined pose out.
int32_t elm_scan_step_p2p(
    // scan
    const double* pts, const double* rel_times, int64_t n_pts,
    // imu window (time-sorted)
    const double* imu_t, const double* imu_gyro, int64_t n_imu,
    double scan_cur, double scan_end, const double* odom_incre,
    // map (packed grid arrays)
    const int32_t* table, const uint32_t* table_fp, int64_t table_size,
    int64_t max_probe, const float* point_blocks, int64_t n_voxels,
    int64_t max_pts_per_voxel, double voxel_size,
    // parameters
    double max_range, double ds_voxel, double max_search, double lm_lambda,
    double term_thresh, double min_overlap, int32_t max_iter,
    // in/out
    double* io_pose, double* out_fitness) {
    if (n_pts <= 0) return -1;

    std::vector<double> ds;
    const int64_t nd = preprocess_scan(pts, rel_times, n_pts, imu_t, imu_gyro,
                                       n_imu, scan_cur, scan_end, odom_incre,
                                       max_range, ds_voxel, ds);
    if (nd == 0) return -1;

    GridView grid{table,    table_fp,  point_blocks, table_size,
                  max_probe, max_pts_per_voxel, n_voxels, voxel_size};

    // 4. RunRegister P2P (registration.cpp:273-418, solver 15-66)
    double pose[16];
    std::memcpy(pose, io_pose, sizeof(pose));
    double fitness = 0.0;
    const double max_d2 = max_search * max_search;
    for (int32_t it = 0; it < max_iter; ++it) {
        double JTJ[36] = {0};
        double JTr[6] = {0};
        double res_sum = 0.0;
        int64_t matched = 0;
        // inverse pose (rigid)
        double Rinv[9], tinv[3];
        for (int r = 0; r < 3; ++r)
            for (int c = 0; c < 3; ++c) Rinv[3 * r + c] = pose[4 * c + r];
        for (int r = 0; r < 3; ++r)
            tinv[r] = -(Rinv[3 * r] * pose[3] + Rinv[3 * r + 1] * pose[7] +
                        Rinv[3 * r + 2] * pose[11]);
        for (int64_t i = 0; i < nd; ++i) {
            const double* s = &ds[3 * i];
            double g[3], tgt[3];
            for (int r = 0; r < 3; ++r)
                g[r] = pose[4 * r] * s[0] + pose[4 * r + 1] * s[1] +
                       pose[4 * r + 2] * s[2] + pose[4 * r + 3];
            if (!grid.nearest(g, max_d2, tgt)) continue;
            ++matched;
            double tl[3];
            for (int r = 0; r < 3; ++r)
                tl[r] = Rinv[3 * r] * tgt[0] + Rinv[3 * r + 1] * tgt[1] +
                        Rinv[3 * r + 2] * tgt[2] + tinv[r];
            const double rv[3] = {tl[0] - s[0], tl[1] - s[1], tl[2] - s[2]};
            const double r2 = rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2];
            const double w =
                max_search * max_search / ((max_search + r2) * (max_search + r2));
            res_sum += std::sqrt(r2);
            // J = [I | -skew(s)]; accumulate w * J^T J and w * J^T r
            // rows of J for residual k: e_k | row k of -skew(s)
            const double Sk[9] = {0, -s[2], s[1], s[2], 0, -s[0], -s[1], s[0], 0};
            double Jr[3][6];
            for (int k = 0; k < 3; ++k) {
                for (int c = 0; c < 3; ++c) Jr[k][c] = (k == c) ? 1.0 : 0.0;
                for (int c = 0; c < 3; ++c) Jr[k][3 + c] = -Sk[3 * k + c];
            }
            for (int a = 0; a < 6; ++a) {
                double ja_r = 0.0;
                for (int k = 0; k < 3; ++k) ja_r += Jr[k][a] * rv[k];
                JTr[a] += w * ja_r;
                for (int b = a; b < 6; ++b) {
                    double acc = 0.0;
                    for (int k = 0; k < 3; ++k) acc += Jr[k][a] * Jr[k][b];
                    JTJ[6 * a + b] += w * acc;
                }
            }
        }
        for (int a = 0; a < 6; ++a)
            for (int b = 0; b < a; ++b) JTJ[6 * a + b] = JTJ[6 * b + a];

        if (static_cast<double>(matched) / static_cast<double>(nd) <
            min_overlap) {
            std::memcpy(io_pose, pose, sizeof(pose));
            *out_fitness = fitness;
            return 0;
        }
        fitness = matched > 0 ? res_sum / static_cast<double>(matched) : 0.0;

        double A[36];
        std::memcpy(A, JTJ, sizeof(A));
        for (int a = 0; a < 6; ++a) A[6 * a + a] += lm_lambda * JTJ[6 * a + a];
        double b6[6];
        std::memcpy(b6, JTr, sizeof(b6));
        double x[6];
        if (!solve6(A, b6, x)) break;

        double Rs[9];
        exp_so3(&x[3], Rs);
        // pose = pose @ [Rs | x[0:3]]
        double np_[16];
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c)
                np_[4 * r + c] = pose[4 * r] * Rs[c] +
                                 pose[4 * r + 1] * Rs[3 + c] +
                                 pose[4 * r + 2] * Rs[6 + c];
            np_[4 * r + 3] = pose[4 * r] * x[0] + pose[4 * r + 1] * x[1] +
                             pose[4 * r + 2] * x[2] + pose[4 * r + 3];
        }
        np_[12] = np_[13] = np_[14] = 0.0;
        np_[15] = 1.0;
        std::memcpy(pose, np_, sizeof(pose));

        const double tr = Rs[0] + Rs[4] + Rs[8];
        const double cosang = std::fmin(1.0, std::fmax(-1.0, (tr - 1.0) / 2.0));
        const double rot_norm = std::acos(cosang);
        const double t_norm =
            std::sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
        if (rot_norm + t_norm < term_thresh) break;
    }

    std::memcpy(io_pose, pose, sizeof(pose));
    *out_fitness = fitness;
    return 1;
}

}  // extern "C"
