// Native host-side helpers of the PyTorch port (scnerf_tpu_torch/native).
//
// The port's own copy of the JAX package's host library
// (scnerf_tpu/native/searchsorted.cpp), with the same entries and results:
//
//  - scnerf_searchsorted: batched row-wise binary search with the
//    torchsearchsorted extension's broadcast rule (either input may have one
//    row) and left/right semantics.
//  - scnerf_permutation: a seeded Fisher-Yates permutation (std::mt19937_64),
//    the same for a seed on every machine.
//  - scnerf_gather_rows / scnerf_gather_pixels: row and (image, y, x) pixel
//    gathers without numpy's fancy-index copies.
//
// Built with plain g++ into build/native/ at first use and bound via ctypes
// from scnerf_tpu_torch/native/__init__.py. The card's kernels are elsewhere
// (scnerf_tpu_torch/csrc/).

#include <cstdint>
#include <algorithm>
#include <random>

extern "C" {

// Binary search in row `a` (length n) for value v.
// side_left: first index where a[i] >= v; else first index where a[i] > v.
static inline int64_t bsearch_row(const float* a, int64_t n, float v, bool side_left) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        bool go_right = side_left ? (a[mid] < v) : (a[mid] <= v);
        if (go_right) lo = mid + 1; else hi = mid;
    }
    return lo;
}

void scnerf_searchsorted(
    const float* a, int64_t a_rows, int64_t a_cols,
    const float* v, int64_t v_rows, int64_t v_cols,
    int64_t* out, bool side_left) {
    int64_t rows = a_rows > v_rows ? a_rows : v_rows;
    for (int64_t r = 0; r < rows; ++r) {
        const float* arow = a + (a_rows == 1 ? 0 : r) * a_cols;
        const float* vrow = v + (v_rows == 1 ? 0 : r) * v_cols;
        int64_t* orow = out + r * v_cols;
        for (int64_t c = 0; c < v_cols; ++c) {
            orow[c] = bsearch_row(arow, a_cols, vrow[c], side_left);
        }
    }
}

// Fisher-Yates permutation with a seeded PRNG (deterministic across runs).
void scnerf_permutation(int64_t n, uint64_t seed, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = i;
    std::mt19937_64 rng(seed);
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = (int64_t)(rng() % (uint64_t)(i + 1));
        std::swap(out[i], out[j]);
    }
}

// Gather rows[idx] from a (n, row_width) f32 matrix into out.
void scnerf_gather_rows(
    const float* data, int64_t n, int64_t row_width,
    const int64_t* idx, int64_t m, float* out) {
    for (int64_t i = 0; i < m; ++i) {
        const float* src = data + idx[i] * row_width;
        float* dst = out + i * row_width;
        std::copy(src, src + row_width, dst);
    }
}

// Gather RGB targets at integer pixel coords from (n_img, H, W, C) f32.
void scnerf_gather_pixels(
    const float* images, int64_t H, int64_t W, int64_t C,
    const int64_t* img_idx, const int64_t* px, const int64_t* py,
    int64_t m, float* out) {
    for (int64_t i = 0; i < m; ++i) {
        const float* src = images + ((img_idx[i] * H + py[i]) * W + px[i]) * C;
        std::copy(src, src + C, out + i * C);
    }
}

}  // extern "C"
