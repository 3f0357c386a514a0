// Host-side bitmap hot paths (own copy of featurebase_tpu/native/bitops.cpp;
// the C++ leg of the runtime around the CUDA kernels).  These back the host
// boundary where dense device words
// become column-id lists and vice versa — the per-bit loops the reference
// runs inside its roaring containers (reference: roaring/roaring.go:573
// Slice, add.go batched adds) — at ctz/branch-free speed instead of
// per-bit numpy shifting.
//
// Built by native/gxx.py at first use: g++ -O3 -shared -fPIC, into
// featurebase_tpu_torch/build/ under a hash of this source.
#include <cstddef>
#include <cstdint>

extern "C" {

// Decode set bits of an n_words uint32 little-endian vector into sorted
// column ids (+base).  Returns the count written, or -1 if cap is too
// small.  Words are scanned 64 bits at a time with ctz extraction.
long long bitops_words_to_cols(const uint32_t* words, size_t n_words,
                               uint64_t base, uint64_t* out, size_t cap) {
    size_t k = 0;
    const uint64_t* w64 = reinterpret_cast<const uint64_t*>(words);
    size_t n64 = n_words / 2;
    for (size_t i = 0; i < n64; i++) {
        uint64_t w = w64[i];
        uint64_t off = base + (uint64_t)i * 64;
        while (w) {
            if (k >= cap) return -1;
            out[k++] = off + (uint64_t)__builtin_ctzll(w);
            w &= w - 1;
        }
    }
    if (n_words & 1) {
        uint32_t w = words[n_words - 1];
        uint64_t off = base + (uint64_t)(n_words - 1) * 32;
        while (w) {
            if (k >= cap) return -1;
            out[k++] = off + (uint64_t)__builtin_ctz(w);
            w &= w - 1;
        }
    }
    return (long long)k;
}

// Scatter sorted column ids into a dense word vector (OR semantics).
void bitops_cols_to_words(const int64_t* cols, size_t n, uint32_t* words,
                          size_t n_words) {
    for (size_t i = 0; i < n; i++) {
        int64_t c = cols[i];
        if (c < 0) continue;
        size_t w = (size_t)(c >> 5);
        if (w < n_words) words[w] |= (uint32_t)1u << (c & 31);
    }
}

// Total popcount of an n_words uint32 vector.
long long bitops_popcount(const uint32_t* words, size_t n_words) {
    long long total = 0;
    const uint64_t* w64 = reinterpret_cast<const uint64_t*>(words);
    size_t n64 = n_words / 2;
    for (size_t i = 0; i < n64; i++)
        total += __builtin_popcountll(w64[i]);
    if (n_words & 1)
        total += __builtin_popcount(words[n_words - 1]);
    return total;
}

}  // extern "C"
