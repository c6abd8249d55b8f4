// Native fast path for voxel-map construction.
//
// Equivalent of the reference's CPU map build (reference:
// src/app/localization/pcm_matching/src/voxel_hash_map.cpp:270-285 AddPoints
// with min-spacing), re-implemented standalone: the insertion is sequential
// and hash-heavy, the one part of the pipeline that belongs on the
// host in C++. Exposed as a C ABI consumed via ctypes
// (elimaloc_tpu/map/native_builder.py); semantics are bit-identical to the
// NumPy fallback in elimaloc_tpu/map/builder.py (floor bucketing, first-come
// insertion order, spacing sqrt(voxel^2 / max_points)).
//
// Build: make -C native   ->  native/build/libelimaloc_native.so

#include <cmath>
#include <cstdint>
#include <limits>
#include <memory>
#include <vector>

namespace {

inline int64_t floor_div(double v, double s) {
    return static_cast<int64_t>(std::floor(v / s));
}

struct KeyHash {
    size_t operator()(uint64_t k) const {
        // splitmix64 finalizer: good avalanche for packed voxel keys.
        uint64_t z = k + 0x9e3779b97f4a7c15ull;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return static_cast<size_t>(z ^ (z >> 31));
    }
};

inline uint64_t pack_key(int64_t x, int64_t y, int64_t z) {
    // 21 bits per axis, offset-shifted: covers +-1M voxels per axis.
    const uint64_t b = 1ull << 20;
    return ((static_cast<uint64_t>(x + b) & 0x1fffffull) << 42) |
           ((static_cast<uint64_t>(y + b) & 0x1fffffull) << 21) |
           (static_cast<uint64_t>(z + b) & 0x1fffffull);
}

}  // namespace

// Two-phase build. The single-pass design allocated the packed point block
// at worst-case capacity (one voxel per point): for an N-point cloud that is
// N*max_pts*3 doubles — 15 GB at 21M points — and the insertion's random row
// writes page-fault across all of it (measured 100 s for 8M points). The
// rebuild is three dense passes:
//   1. `elm_build_begin`: hash each point's voxel once, assigning compact row
//      ids in first-occurrence order, then STABLY counting-sort the point
//      indices by row — per-voxel candidates become contiguous while keeping
//      the global arrival order inside each voxel, so the min-spacing
//      acceptance decisions are bit-identical to the sequential insert.
//   2. caller reads `elm_build_num_voxels` and allocates exact-size outputs.
//   3. `elm_build_finish`: per-voxel min-spacing insertion, written
//      sequentially (row-major) into the caller's arrays; frees the handle.
// Peak extra memory is ~8 bytes/point of index scratch instead of
// max_pts*24 bytes/POINT of padded block.

struct BuildState {
    std::vector<int64_t> coords;    // 3 per voxel, first-occurrence order
    std::vector<double> grouped;    // point coords regrouped by row (stable)
    std::vector<int64_t> start;     // v+1 row offsets into `grouped`/3
    double voxel_size = 0.0;
    int64_t max_pts = 0;
};

namespace {

// Open-addressing voxel-key table (linear probing, splitmix64, pow-2 size).
// pack_key uses 63 bits so all-ones can never be a real key — it is the
// empty-slot sentinel. ~3x faster than std::unordered_map on this workload.
struct KeyTable {
    static constexpr uint64_t kEmpty = ~0ull;
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;

    explicit KeyTable(int64_t n) {
        size_t size = 16;
        while (size < static_cast<size_t>(n) * 2) size <<= 1;
        keys.assign(size, kEmpty);
        vals.resize(size);
        mask = size - 1;
    }

    // Returns the row for `key`, inserting `fresh_row` if absent; sets
    // `inserted`.
    int32_t get_or_insert(uint64_t key, int32_t fresh_row, bool* inserted) {
        size_t slot = KeyHash{}(key) & mask;
        while (true) {
            if (keys[slot] == kEmpty) {
                keys[slot] = key;
                vals[slot] = fresh_row;
                *inserted = true;
                return fresh_row;
            }
            if (keys[slot] == key) {
                *inserted = false;
                return vals[slot];
            }
            slot = (slot + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// Returns nullptr on allocation failure (a bad_alloc must not unwind
// through the ctypes FFI boundary — it would std::terminate the process).
void* elm_build_begin(const double* points, int64_t n, double voxel_size,
                      int64_t max_pts) try {
    std::unique_ptr<BuildState> st(new BuildState);
    st->voxel_size = voxel_size;
    st->max_pts = max_pts;

    std::vector<int32_t> row_of(static_cast<size_t>(n));
    KeyTable table(n);
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double* p = points + 3 * i;
        const int64_t kx = floor_div(p[0], voxel_size);
        const int64_t ky = floor_div(p[1], voxel_size);
        const int64_t kz = floor_div(p[2], voxel_size);
        bool inserted;
        const int32_t row = table.get_or_insert(
            pack_key(kx, ky, kz), static_cast<int32_t>(v), &inserted);
        if (inserted) {
            st->coords.push_back(kx);
            st->coords.push_back(ky);
            st->coords.push_back(kz);
            ++v;
        }
        row_of[static_cast<size_t>(i)] = row;
    }

    // Stable counting sort: regroup the point COORDS (not indices) by row so
    // the finish pass streams each voxel's candidates from contiguous
    // memory. Per-voxel arrival order is the global order — the min-spacing
    // decisions below are bit-identical to a sequential insert.
    st->start.assign(static_cast<size_t>(v) + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++st->start[row_of[i] + 1];
    for (int64_t r = 0; r < v; ++r) st->start[r + 1] += st->start[r];
    st->grouped.resize(static_cast<size_t>(n) * 3);
    std::vector<int64_t> cursor(st->start.begin(), st->start.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
        double* dst = st->grouped.data() + 3 * cursor[row_of[i]]++;
        const double* p = points + 3 * i;
        dst[0] = p[0];
        dst[1] = p[1];
        dst[2] = p[2];
    }
    return st.release();
} catch (...) {
    return nullptr;
}

int64_t elm_build_num_voxels(void* handle) {
    return static_cast<int64_t>(
        static_cast<BuildState*>(handle)->coords.size() / 3);
}

// Consumes and frees the handle. Per voxel, while its points are hot in
// cache: min-spacing insertion on RAW f64 coords, then the stored rows are
// rounded to their float32 values (the device store dtype — covariances must
// be computed from what the device will actually hold, builder.py:177-181),
// pad rows are set to +inf (the packed-map pad sentinel, builder._pad_inf),
// and the f32-rounded mean and raw sample covariance are accumulated in f64.
// Plane regularization (SVD) stays in Python/LAPACK.
void elm_build_finish(void* handle, int64_t* out_coords, double* out_block,
                      int64_t* out_counts, double* out_mean,
                      double* out_cov) {
    auto* st = static_cast<BuildState*>(handle);
    const int64_t v = static_cast<int64_t>(st->coords.size() / 3);
    const int64_t m = st->max_pts;
    const double res2 =
        st->voxel_size * st->voxel_size / static_cast<double>(m);
    const double inf = std::numeric_limits<double>::infinity();

    for (int64_t r = 0; r < v; ++r) {
        out_coords[3 * r + 0] = st->coords[3 * r + 0];
        out_coords[3 * r + 1] = st->coords[3 * r + 1];
        out_coords[3 * r + 2] = st->coords[3 * r + 2];
        double* block = out_block + r * m * 3;
        int64_t cnt = 0;
        for (int64_t k = st->start[r]; k < st->start[r + 1] && cnt < m; ++k) {
            const double* p = st->grouped.data() + 3 * k;
            // Min-spacing rule (voxel_hash_map.hpp:106-113): reject the
            // point if any stored point in this voxel is within sqrt(res2).
            bool too_close = false;
            for (int64_t j = 0; j < cnt; ++j) {
                const double dx = block[3 * j + 0] - p[0];
                const double dy = block[3 * j + 1] - p[1];
                const double dz = block[3 * j + 2] - p[2];
                if (dx * dx + dy * dy + dz * dz < res2) {
                    too_close = true;
                    break;
                }
            }
            if (too_close) continue;
            block[3 * cnt + 0] = p[0];
            block[3 * cnt + 1] = p[1];
            block[3 * cnt + 2] = p[2];
            ++cnt;
        }
        out_counts[r] = cnt;

        double mean[3] = {0.0, 0.0, 0.0};
        for (int64_t j = 0; j < cnt; ++j) {
            for (int d = 0; d < 3; ++d) {
                const double rounded =
                    static_cast<double>(static_cast<float>(block[3 * j + d]));
                block[3 * j + d] = rounded;
                mean[d] += rounded;
            }
        }
        const double denom = cnt > 0 ? static_cast<double>(cnt) : 1.0;
        for (int d = 0; d < 3; ++d) mean[d] /= denom;
        out_mean[3 * r + 0] = mean[0];
        out_mean[3 * r + 1] = mean[1];
        out_mean[3 * r + 2] = mean[2];

        double cov[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        for (int64_t j = 0; j < cnt; ++j) {
            const double cx = block[3 * j + 0] - mean[0];
            const double cy = block[3 * j + 1] - mean[1];
            const double cz = block[3 * j + 2] - mean[2];
            cov[0] += cx * cx; cov[1] += cx * cy; cov[2] += cx * cz;
            cov[4] += cy * cy; cov[5] += cy * cz; cov[8] += cz * cz;
        }
        const double cdenom = cnt > 1 ? static_cast<double>(cnt - 1) : 1.0;
        cov[0] /= cdenom; cov[1] /= cdenom; cov[2] /= cdenom;
        cov[4] /= cdenom; cov[5] /= cdenom; cov[8] /= cdenom;
        cov[3] = cov[1]; cov[6] = cov[2]; cov[7] = cov[5];
        for (int d = 0; d < 9; ++d) out_cov[9 * r + d] = cov[d];

        for (int64_t j = cnt; j < m; ++j) {
            block[3 * j + 0] = inf;
            block[3 * j + 1] = inf;
            block[3 * j + 2] = inf;
        }
    }
    delete st;
}

void elm_build_free(void* handle) { delete static_cast<BuildState*>(handle); }

// LZF decompression (Marc Lehmann's liblzf stream format, as produced by
// PCL's binary_compressed PCD writer). Returns output length or -1.
int64_t elm_lzf_decompress(const unsigned char* in, int64_t in_len,
                           unsigned char* out, int64_t out_cap) {
    int64_t i = 0, o = 0;
    while (i < in_len) {
        unsigned int ctrl = in[i++];
        if (ctrl < 32) {  // literal run
            int64_t cnt = static_cast<int64_t>(ctrl) + 1;
            if (i + cnt > in_len || o + cnt > out_cap) return -1;
            for (int64_t k = 0; k < cnt; ++k) out[o++] = in[i++];
        } else {  // back reference
            int64_t len = ctrl >> 5;
            if (len == 7) {
                if (i >= in_len) return -1;
                len += in[i++];
            }
            if (i >= in_len) return -1;
            int64_t ref = o - ((ctrl & 0x1f) << 8) - in[i++] - 1;
            if (ref < 0 || o + len + 2 > out_cap) return -1;
            for (int64_t k = 0; k < len + 2; ++k) {
                out[o] = out[ref];
                ++o;
                ++ref;
            }
        }
    }
    return o;
}

}  // extern "C"
