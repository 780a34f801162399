// Native rANS entropy codec for categorical symbol streams.
//
// C++ core of gsvc_tpu.compress.entropy — this framework's
// replacement for the reference's `constriction` Rust library
// (reference quantize.py:152-180). Bit-identical to the numpy fallback in
// gsvc_tpu/compress/entropy.py (same 64-bit state, 32-bit renormalization
// words, PRECISION=16 quantized pmf, encode-in-reverse/decode-forward
// stack convention); the Python implementation is the test oracle.
//
// Exposed through a plain C ABI and loaded via ctypes (no pybind11 in the
// image). Built lazily by gsvc_tpu/native/__init__.py — the analog of the
// reference's JIT extension build (gsplat/gsplat/cuda/_backend.py:54-98) —
// or ahead-of-time with gsvc_tpu/native/Makefile.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint64_t kProbScale = 1ull << kPrecision;
constexpr uint64_t kStateLo = 1ull << 32;

}  // namespace

extern "C" {

// Encode n symbols (values in [0, n_sym)) with integer pmf `pmf_q`
// (summing to 2^16). Writes up to `out_cap` uint32 words to `out_words`.
// Returns the number of words written, or 0 if out_cap is too small.
size_t rans_encode(const int32_t* msg, size_t n, const int64_t* pmf_q,
                   size_t n_sym, uint32_t* out_words, size_t out_cap) {
  std::vector<uint64_t> cdf(n_sym + 1, 0);
  for (size_t s = 0; s < n_sym; ++s) cdf[s + 1] = cdf[s] + (uint64_t)pmf_q[s];

  uint64_t state = kStateLo;
  size_t w = 0;
  // Reverse order so decoding is a forward scan.
  for (size_t i = n; i-- > 0;) {
    const uint64_t s = (uint64_t)msg[i];
    const uint64_t freq = (uint64_t)pmf_q[s];
    // Renorm bound: keep state < freq << 48 before the push so the
    // decoder's [2^32, 2^64) invariant holds. (state >> 48) >= freq is the
    // overflow-safe form of state >= (freq << 48).
    while ((state >> 48) >= freq) {
      if (w >= out_cap) return 0;
      out_words[w++] = (uint32_t)(state & 0xFFFFFFFFull);
      state >>= 32;
    }
    state = ((state / freq) << kPrecision) + (state % freq) + cdf[s];
  }
  if (w + 2 > out_cap) return 0;
  out_words[w++] = (uint32_t)(state & 0xFFFFFFFFull);
  out_words[w++] = (uint32_t)(state >> 32);
  return w;
}

// Decode n symbols from `words` (n_words uint32) with pmf `pmf_q`.
// Returns 0 on success, nonzero on malformed input.
int rans_decode(const uint32_t* words, size_t n_words, const int64_t* pmf_q,
                size_t n_sym, size_t n, int32_t* out) {
  if (n_words < 2) return 1;
  std::vector<uint64_t> cdf(n_sym + 1, 0);
  for (size_t s = 0; s < n_sym; ++s) cdf[s + 1] = cdf[s] + (uint64_t)pmf_q[s];
  if (cdf[n_sym] != kProbScale) return 2;

  // Slot -> symbol lookup table over the 2^16 probability slots.
  std::vector<int32_t> lut(kProbScale);
  for (size_t s = 0; s < n_sym; ++s)
    for (uint64_t k = cdf[s]; k < cdf[s + 1]; ++k) lut[k] = (int32_t)s;

  size_t pos = n_words - 1;
  uint64_t state = ((uint64_t)words[pos] << 32) | (uint64_t)words[pos - 1];
  pos = (pos >= 2) ? pos - 2 : (size_t)-1;
  for (size_t i = 0; i < n; ++i) {
    const uint64_t slot = state & (kProbScale - 1);
    const int32_t s = lut[slot];
    const uint64_t freq = (uint64_t)pmf_q[s];
    state = freq * (state >> kPrecision) + slot - cdf[s];
    while (state < kStateLo && pos != (size_t)-1) {
      state = (state << 32) | (uint64_t)words[pos];
      pos = (pos >= 1) ? pos - 1 : (size_t)-1;
    }
    out[i] = s;
  }
  return 0;
}

}  // extern "C"
