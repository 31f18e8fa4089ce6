// Host-side coders of the PyTorch/CUDA port: z latents and the
// autoregressive y latents.
//
// A copy of the subset of hesic_tpu/codecs/csrc/rans.cpp that the port's
// codecs use, kept byte-for-byte in its arithmetic so strings are
// identical to the JAX package's at equal inputs and tables:
//   * rANS (64-bit state, 32-bit word renormalization, 16-bit probability
//     resolution, escape/bypass coding in 4-bit chunks), CompressAI framing;
//   * pmf_to_quantized_cdf: float PMF -> integer CDF summing to 2^precision
//     with frequency stealing so no symbol has zero width;
//   * the stateful (streaming) rANS decoder of the autoregressive codecs'
//     numpy cross-check decoder, and the row rANS coders (one CDF row per
//     symbol, no escapes);
//   * the LZMA-style range coder (arbitrary CDF totals) of the
//     reference-layout container codecs (HESICCodec, DSICCodec,
//     HESICPlusRefCodec);
//   * the autoregressive (raster-causal) coder of the host AR codecs
//     (hesic_ar_code), one float implementation for encode and decode.
// The API is array-oriented (raw pointers + lengths, C ABI for ctypes).
//
// Build (hesic_tpu_torch/codecs/build.py), the JAX package's flags:
//   g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC -Wall
//       -march=native rans.cpp -o librans-<host tag>.so
// and without -march=native where the compiler refuses it.  With FMA
// contraction off, -march=native only vectorizes the AR coder's
// independent output lanes; no sum changes its order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;          // probability resolution
constexpr uint64_t kRansL = 1ull << 31;     // lower renormalization bound
constexpr uint32_t kBypassBits = 4;         // raw-bits chunk size
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;

// ---------------------------------------------------------------------------
// rANS core (64-bit state, u32 emission)
// ---------------------------------------------------------------------------

struct RansState {
  uint64_t x = kRansL;
};

// One buffered symbol: either a (start, freq) interval at 16-bit resolution
// or `nbits` raw bits in `start` (bypass mode, freq field reused as nbits).
struct Buffered {
  uint32_t start;
  uint32_t freq;
  uint8_t raw_bits;  // 0 => interval symbol; >0 => raw-bits symbol
};

// Encoder writes u32 words back-to-front into `words`; `pos` is the index of
// the first valid word.
struct WordSink {
  std::vector<uint32_t> words;
  size_t pos;
  explicit WordSink(size_t cap) : words(cap), pos(cap) {}
  inline void put(uint32_t w) { words[--pos] = w; }
  size_t size_bytes() const { return (words.size() - pos) * 4; }
};

inline void rans_enc_put(RansState& r, WordSink& sink, uint32_t start,
                         uint32_t freq) {
  uint64_t x = r.x;
  const uint64_t x_max = ((kRansL >> kProbBits) << 32) * freq;
  if (x >= x_max) {
    sink.put(static_cast<uint32_t>(x));
    x >>= 32;
  }
  r.x = ((x / freq) << kProbBits) + (x % freq) + start;
}

inline void rans_enc_put_bits(RansState& r, WordSink& sink, uint32_t val,
                              uint32_t nbits) {
  uint64_t x = r.x;
  const uint32_t freq = 1u << (kProbBits - nbits);
  const uint64_t x_max = ((kRansL >> kProbBits) << 32) * freq;
  if (x >= x_max) {
    sink.put(static_cast<uint32_t>(x));
    x >>= 32;
  }
  r.x = (x << nbits) | val;
}

inline void rans_enc_flush(RansState& r, WordSink& sink) {
  sink.put(static_cast<uint32_t>(r.x >> 32));
  sink.put(static_cast<uint32_t>(r.x));
}

struct WordSource {
  const uint32_t* ptr;
  const uint32_t* end;
};

inline void rans_dec_init(RansState& r, WordSource& src) {
  uint64_t x = static_cast<uint64_t>(src.ptr[0]);
  x |= static_cast<uint64_t>(src.ptr[1]) << 32;
  src.ptr += 2;
  r.x = x;
}

inline uint32_t rans_dec_peek(const RansState& r) {
  return static_cast<uint32_t>(r.x & ((1u << kProbBits) - 1));
}

inline void rans_dec_advance(RansState& r, WordSource& src, uint32_t start,
                             uint32_t freq) {
  const uint64_t mask = (1ull << kProbBits) - 1;
  uint64_t x = r.x;
  x = freq * (x >> kProbBits) + (x & mask) - start;
  if (x < kRansL && src.ptr < src.end) {
    x = (x << 32) | *src.ptr++;
  }
  r.x = x;
}

inline uint32_t rans_dec_get_bits(RansState& r, WordSource& src,
                                  uint32_t nbits) {
  uint64_t x = r.x;
  const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
  x >>= nbits;
  if (x < kRansL && src.ptr < src.end) {
    x = (x << 32) | *src.ptr++;
  }
  r.x = x;
  return val;
}

// ---------------------------------------------------------------------------
// Indexed symbol coding with escape/bypass (CompressAI bitstream framing)
// ---------------------------------------------------------------------------

// Map one signed residual to interval + optional bypass chunks and append to
// the buffer.  `cdf` has `cdf_size` entries; the last interval (index
// cdf_size-2) is the escape symbol.
inline void buffer_symbol(std::vector<Buffered>& buf, int32_t value,
                          const int32_t* cdf, int32_t cdf_size) {
  const int32_t max_value = cdf_size - 2;
  uint32_t raw = 0;
  bool escaped = false;
  if (value < 0) {
    raw = static_cast<uint32_t>(-2 * value - 1);
    value = max_value;
    escaped = true;
  } else if (value >= max_value) {
    raw = static_cast<uint32_t>(2 * (value - max_value));
    value = max_value;
    escaped = true;
  }
  buf.push_back({static_cast<uint32_t>(cdf[value]),
                 static_cast<uint32_t>(cdf[value + 1] - cdf[value]), 0});
  if (escaped) {
    // chunk count, unary-ish in base (2^kBypassBits - 1)
    uint32_t n_chunks = 0;
    while ((raw >> (n_chunks * kBypassBits)) != 0) ++n_chunks;
    uint32_t rem = n_chunks;
    while (rem >= kBypassMax) {
      buf.push_back({kBypassMax, 0, static_cast<uint8_t>(kBypassBits)});
      rem -= kBypassMax;
    }
    buf.push_back({rem, 0, static_cast<uint8_t>(kBypassBits)});
    for (uint32_t j = 0; j < n_chunks; ++j) {
      buf.push_back({(raw >> (j * kBypassBits)) & kBypassMax, 0,
                     static_cast<uint8_t>(kBypassBits)});
    }
  }
}

int64_t flush_buffer(const std::vector<Buffered>& buf, uint8_t* out,
                     int64_t out_cap) {
  RansState rans;
  WordSink sink(buf.size() + 2);
  for (size_t i = buf.size(); i-- > 0;) {
    const Buffered& s = buf[i];
    if (s.raw_bits == 0) {
      rans_enc_put(rans, sink, s.start, s.freq);
    } else {
      rans_enc_put_bits(rans, sink, s.start, s.raw_bits);
    }
  }
  rans_enc_flush(rans, sink);
  const int64_t nbytes = static_cast<int64_t>(sink.size_bytes());
  if (nbytes > out_cap) return -nbytes;  // caller retries with bigger buffer
  std::memcpy(out, sink.words.data() + sink.pos, nbytes);
  return nbytes;
}

// Decode one symbol (interval + possible bypass) given its cdf row.
inline int32_t decode_symbol(RansState& rans, WordSource& src,
                             const int32_t* cdf, int32_t cdf_size) {
  const int32_t max_value = cdf_size - 2;
  const uint32_t cf = rans_dec_peek(rans);
  // Linear scan; rows are short (tens of entries) and usually hit early.
  int32_t s = 0;
  while (s + 1 < cdf_size && static_cast<uint32_t>(cdf[s + 1]) <= cf) ++s;
  rans_dec_advance(rans, src, cdf[s], cdf[s + 1] - cdf[s]);
  int32_t value = s;
  if (value == max_value) {
    uint32_t val = rans_dec_get_bits(rans, src, kBypassBits);
    uint32_t n_chunks = val;
    while (val == kBypassMax) {
      val = rans_dec_get_bits(rans, src, kBypassBits);
      n_chunks += val;
    }
    uint32_t raw = 0;
    for (uint32_t j = 0; j < n_chunks; ++j) {
      raw |= rans_dec_get_bits(rans, src, kBypassBits) << (j * kBypassBits);
    }
    value = static_cast<int32_t>(raw >> 1);
    if (raw & 1) {
      value = -value - 1;
    } else {
      value += max_value;
    }
  }
  return value;
}

// ---------------------------------------------------------------------------
// LZMA-style range coder (arbitrary CDF totals)
// ---------------------------------------------------------------------------

constexpr uint32_t kRcTop = 1u << 24;

struct RcEncoder {
  std::vector<uint8_t> out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;

  inline void shift_low() {
    if (static_cast<uint32_t>(low >> 32) != 0 ||
        static_cast<uint32_t>(low) < 0xFF000000u) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      do {
        out.push_back(static_cast<uint8_t>(cache + carry));
        cache = 0xFF;
      } while (--cache_size != 0);
      cache = static_cast<uint8_t>(low >> 24);
    }
    ++cache_size;
    low = (static_cast<uint32_t>(low)) << 8;
  }

  inline void encode(uint32_t start, uint32_t freq, uint32_t total) {
    range /= total;
    low += static_cast<uint64_t>(start) * range;
    range *= freq;
    while (range < kRcTop) {
      range <<= 8;
      shift_low();
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct RcDecoder {
  const uint8_t* ptr;
  const uint8_t* end;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  void init(const uint8_t* data, int64_t n) {
    ptr = data;
    end = data + n;
    range = 0xFFFFFFFFu;
    code = 0;
    for (int i = 0; i < 5; ++i) code = (code << 8) | next_byte();
  }

  inline uint8_t next_byte() { return ptr < end ? *ptr++ : 0; }

  inline uint32_t get_freq(uint32_t total) {
    range /= total;
    return code / range;
  }

  inline void advance(uint32_t start, uint32_t freq) {
    code -= start * range;
    range *= freq;
    while (range < kRcTop) {
      code = (code << 8) | next_byte();
      range <<= 8;
    }
  }
};


// ---------------------------------------------------------------------------
// PMF -> quantized CDF (integer algorithm, frequency stealing)
// ---------------------------------------------------------------------------

// Functional equivalent of the reference quantizer (ops.cpp:24-81): the exact
// sequence round -> integer rescale -> prefix sum -> pin top -> steal from the
// smallest >1 bin determines the bitstream, so every step here is integer
// arithmetic in the same order.
int quantize_pmf(const float* pmf, int32_t n, int precision, int32_t* cdf) {
  const int64_t one = 1ll << precision;
  std::vector<uint32_t> freq(n + 1);
  freq[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    float p = pmf[i];
    if (!(p >= 0.f)) p = 0.f;  // NaN / negative guard
    freq[i + 1] = static_cast<uint32_t>(std::round(p * one));
  }
  uint32_t total = 0;
  for (uint32_t f : freq) total += f;
  if (total == 0) {
    // degenerate input: uniform fallback
    for (int32_t i = 0; i <= n; ++i)
      cdf[i] = static_cast<int32_t>((one * i) / n);
    cdf[n] = static_cast<int32_t>(one);
    return 0;
  }
  std::vector<uint32_t> c(n + 1);
  for (int32_t i = 0; i <= n; ++i) {
    c[i] = static_cast<uint32_t>(
        (static_cast<uint64_t>(one) * freq[i]) / total);
  }
  for (int32_t i = 1; i <= n; ++i) c[i] += c[i - 1];
  c[n] = static_cast<uint32_t>(one);

  for (int32_t i = 0; i < n; ++i) {
    if (c[i] != c[i + 1]) continue;
    // steal one count from the smallest bin with freq > 1
    uint32_t best_freq = ~0u;
    int32_t best = -1;
    for (int32_t j = 0; j < n; ++j) {
      const uint32_t f = c[j + 1] - c[j];
      if (f > 1 && f < best_freq) {
        best_freq = f;
        best = j;
      }
    }
    if (best < 0) return -1;
    if (best < i) {
      for (int32_t j = best + 1; j <= i; ++j) --c[j];
    } else {
      for (int32_t j = i + 1; j <= best; ++j) ++c[j];
    }
  }
  for (int32_t i = 0; i <= n; ++i) cdf[i] = static_cast<int32_t>(c[i]);
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- CDF quantization ----

// pmf: [n] float; cdf_out: [n+1] int32.  Returns 0 on success.
int hesic_pmf_to_quantized_cdf(const float* pmf, int32_t n, int32_t precision,
                               int32_t* cdf_out) {
  return quantize_pmf(pmf, n, precision, cdf_out);
}

// Batched variant over a padded table.
//   pmfs:        [num, max_len]   (row i valid up to pmf_lengths[i])
//   tail_mass:   [num]            appended as one extra bin per row
//   cdf_out:     [num, max_len+2] zero-padded rows
// Row i's quantized CDF has pmf_lengths[i]+2 entries.
int hesic_pmf_to_quantized_cdf_batch(const float* pmfs,
                                     const int32_t* pmf_lengths,
                                     const float* tail_mass, int32_t num,
                                     int32_t max_len, int32_t precision,
                                     int32_t* cdf_out) {
  std::vector<float> row(max_len + 1);
  const int32_t stride = max_len + 2;
  std::memset(cdf_out, 0, sizeof(int32_t) * static_cast<size_t>(num) * stride);
  for (int32_t i = 0; i < num; ++i) {
    const int32_t len = pmf_lengths[i];
    if (len < 0 || len > max_len) return -2;
    std::memcpy(row.data(), pmfs + static_cast<size_t>(i) * max_len,
                sizeof(float) * len);
    row[len] = tail_mass[i];
    const int rc = quantize_pmf(row.data(), len + 1, precision,
                                cdf_out + static_cast<size_t>(i) * stride);
    if (rc != 0) return rc;
  }
  return 0;
}

// ---- rANS, indexed API (tabled CDFs shared across symbols) ----

// CDF validation, compiled in only with -DHESIC_DEBUG: every table row
// must start at 0, end at 2^16, and be non-decreasing.
static bool cdfs_valid(const int32_t* cdfs, int32_t cdf_stride,
                       const int32_t* cdf_sizes, int32_t ncdfs) {
#ifdef HESIC_DEBUG
  for (int32_t i = 0; i < ncdfs; ++i) {
    const int32_t* cdf = cdfs + static_cast<size_t>(i) * cdf_stride;
    const int32_t len = cdf_sizes[i];
    if (len < 2 || len > cdf_stride) return false;
    if (cdf[0] != 0 || cdf[len - 1] != (1 << kProbBits)) return false;
    for (int32_t j = 1; j < len; ++j)
      if (cdf[j] < cdf[j - 1]) return false;
  }
#else
  (void)cdfs; (void)cdf_stride; (void)cdf_sizes; (void)ncdfs;
#endif
  return true;
}

// symbols/indexes: [n] int32.  cdfs: [ncdfs, cdf_stride] int32 row-major;
// cdf_sizes/offsets: [ncdfs].  Returns encoded byte count, or negative
// required capacity if out_cap is too small.
int64_t hesic_rans_encode_with_indexes(const int32_t* symbols,
                                       const int32_t* indexes, int64_t n,
                                       const int32_t* cdfs, int32_t cdf_stride,
                                       const int32_t* cdf_sizes,
                                       const int32_t* offsets, int32_t ncdfs,
                                       uint8_t* out, int64_t out_cap) {
  if (!cdfs_valid(cdfs, cdf_stride, cdf_sizes, ncdfs)) return -3;
  std::vector<Buffered> buf;
  buf.reserve(static_cast<size_t>(n) + 16);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -1;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * cdf_stride;
    buffer_symbol(buf, symbols[i] - offsets[idx], cdf, cdf_sizes[idx]);
  }
  return flush_buffer(buf, out, out_cap);
}

int64_t hesic_rans_decode_with_indexes(const uint8_t* data, int64_t nbytes,
                                       const int32_t* indexes, int64_t n,
                                       const int32_t* cdfs, int32_t cdf_stride,
                                       const int32_t* cdf_sizes,
                                       const int32_t* offsets, int32_t ncdfs,
                                       int32_t* out) {
  if (nbytes < 8 || (nbytes % 4) != 0) return -1;
  if (!cdfs_valid(cdfs, cdf_stride, cdf_sizes, ncdfs)) return -3;
  RansState rans;
  WordSource src{reinterpret_cast<const uint32_t*>(data),
                 reinterpret_cast<const uint32_t*>(data + nbytes)};
  rans_dec_init(rans, src);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -1;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * cdf_stride;
    out[i] = decode_symbol(rans, src, cdf, cdf_sizes[idx]) + offsets[idx];
  }
  return n;
}

// ---- rANS, batched multi-stream API ----
//
// The flagship batch container codes B pairs x 2 eyes of z latents as 2B
// INDEPENDENT streams sharing one CDF table and one broadcast index vector
// (channel id per element).  Encoding them as one native call removes the
// per-stream Python dispatch loop from the encode hot path (the reference
// has no batch concept at all — entropy_models.py:188-195 marshals one
// Python list per image).

// symbols: (n_streams, n_per) row-major; indexes: (n_per,) shared.
// out: (n_streams, cap_per) row-major; out_lens: (n_streams,).
// Returns 0 on success, -needed_cap if any stream outgrew cap_per,
// -1 bad index, -3 invalid CDFs under HESIC_DEBUG.
int64_t hesic_rans_encode_batch(const int32_t* symbols, const int32_t* indexes,
                                int64_t n_per, int32_t n_streams,
                                const int32_t* cdfs, int32_t cdf_stride,
                                const int32_t* cdf_sizes,
                                const int32_t* offsets, int32_t ncdfs,
                                uint8_t* out, int64_t cap_per,
                                int64_t* out_lens) {
  if (!cdfs_valid(cdfs, cdf_stride, cdf_sizes, ncdfs)) return -3;
  // hoist the per-element index validation + cdf row lookup: the index
  // vector is shared by every stream
  std::vector<const int32_t*> rows(n_per);
  std::vector<int32_t> sizes(n_per), offs(n_per);
  for (int64_t i = 0; i < n_per; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -1;
    rows[i] = cdfs + static_cast<size_t>(idx) * cdf_stride;
    sizes[i] = cdf_sizes[idx];
    offs[i] = offsets[idx];
  }
  std::vector<Buffered> buf;
  buf.reserve(static_cast<size_t>(n_per) + 16);
  for (int32_t s = 0; s < n_streams; ++s) {
    buf.clear();
    const int32_t* sym = symbols + static_cast<size_t>(s) * n_per;
    for (int64_t i = 0; i < n_per; ++i)
      buffer_symbol(buf, sym[i] - offs[i], rows[i], sizes[i]);
    const int64_t n = flush_buffer(
        buf, out + static_cast<size_t>(s) * cap_per, cap_per);
    if (n < 0) return n;  // -needed: caller retries with a bigger cap
    out_lens[s] = n;
  }
  return 0;
}

// data: one buffer holding every stream (e.g. the whole container blob);
// begins/ends: (n_streams,) byte extents of each stream inside it (streams
// may interleave with other container sections).  out: (n_streams, n_per).
int64_t hesic_rans_decode_batch(const uint8_t* data, const int64_t* begins,
                                const int64_t* ends, const int32_t* indexes,
                                int64_t n_per, int32_t n_streams,
                                const int32_t* cdfs, int32_t cdf_stride,
                                const int32_t* cdf_sizes,
                                const int32_t* offsets, int32_t ncdfs,
                                int32_t* out) {
  if (!cdfs_valid(cdfs, cdf_stride, cdf_sizes, ncdfs)) return -3;
  std::vector<const int32_t*> rows(n_per);
  std::vector<int32_t> sizes(n_per), offs(n_per);
  for (int64_t i = 0; i < n_per; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -1;
    rows[i] = cdfs + static_cast<size_t>(idx) * cdf_stride;
    sizes[i] = cdf_sizes[idx];
    offs[i] = offsets[idx];
  }
  for (int32_t s = 0; s < n_streams; ++s) {
    const int64_t lo = begins[s], hi = ends[s];
    const int64_t nbytes = hi - lo;
    if (nbytes < 8 || (nbytes % 4) != 0) return -1;
    RansState rans;
    WordSource src{reinterpret_cast<const uint32_t*>(data + lo),
                   reinterpret_cast<const uint32_t*>(data + hi)};
    rans_dec_init(rans, src);
    int32_t* dst = out + static_cast<size_t>(s) * n_per;
    for (int64_t i = 0; i < n_per; ++i)
      dst[i] = decode_symbol(rans, src, rows[i], sizes[i]) + offs[i];
  }
  return n_per * n_streams;
}


// ---- rANS, per-symbol CDF rows (device-computed tables, no escapes) ----

// Each symbol i draws from its own row cdf_rows[i] of `row_len` entries
// (row_len-1 symbols).  Symbols must already lie in [0, row_len-2].
int64_t hesic_rans_encode_with_rows(const int32_t* symbols, int64_t n,
                                    const int32_t* cdf_rows, int32_t row_len,
                                    uint8_t* out, int64_t out_cap) {
  std::vector<Buffered> buf;
  buf.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* cdf = cdf_rows + static_cast<size_t>(i) * row_len;
    const int32_t s = symbols[i];
    if (s < 0 || s >= row_len - 1) return -1;
    buf.push_back({static_cast<uint32_t>(cdf[s]),
                   static_cast<uint32_t>(cdf[s + 1] - cdf[s]), 0});
  }
  return flush_buffer(buf, out, out_cap);
}

int64_t hesic_rans_decode_with_rows(const uint8_t* data, int64_t nbytes,
                                    int64_t n, const int32_t* cdf_rows,
                                    int32_t row_len, int32_t* out) {
  if (nbytes < 8 || (nbytes % 4) != 0) return -1;
  RansState rans;
  WordSource src{reinterpret_cast<const uint32_t*>(data),
                 reinterpret_cast<const uint32_t*>(data + nbytes)};
  rans_dec_init(rans, src);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* cdf = cdf_rows + static_cast<size_t>(i) * row_len;
    const uint32_t cf = rans_dec_peek(rans);
    int32_t s = 0;
    while (s + 1 < row_len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cf) ++s;
    rans_dec_advance(rans, src, cdf[s], cdf[s + 1] - cdf[s]);
    out[i] = s;
  }
  return n;
}

// ---- rANS, stateful decoder (autoregressive models) ----

struct HesicRansDecoder {
  std::vector<uint8_t> data;
  RansState rans;
  WordSource src;
};

void* hesic_rans_decoder_new(const uint8_t* data, int64_t nbytes) {
  if (nbytes < 8 || (nbytes % 4) != 0) return nullptr;
  auto* d = new HesicRansDecoder();
  d->data.assign(data, data + nbytes);
  d->src.ptr = reinterpret_cast<const uint32_t*>(d->data.data());
  d->src.end = reinterpret_cast<const uint32_t*>(d->data.data() + nbytes);
  rans_dec_init(d->rans, d->src);
  return d;
}

void hesic_rans_decoder_free(void* dec) {
  delete static_cast<HesicRansDecoder*>(dec);
}

int64_t hesic_rans_decoder_decode(void* dec, const int32_t* indexes, int64_t n,
                                  const int32_t* cdfs, int32_t cdf_stride,
                                  const int32_t* cdf_sizes,
                                  const int32_t* offsets, int32_t ncdfs,
                                  int32_t* out) {
  auto* d = static_cast<HesicRansDecoder*>(dec);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    if (idx < 0 || idx >= ncdfs) return -1;
    const int32_t* cdf = cdfs + static_cast<size_t>(idx) * cdf_stride;
    out[i] = decode_symbol(d->rans, d->src, cdf, cdf_sizes[idx]) + offsets[idx];
  }
  return n;
}

// ---- Range coder (arbitrary totals; HESIC y-path container) ----

void* hesic_rc_encoder_new() { return new RcEncoder(); }

void hesic_rc_encoder_free(void* enc) { delete static_cast<RcEncoder*>(enc); }

// Encode n symbols sharing one cdf (len entries; total = cdf[len-1]).
int hesic_rc_encode(void* enc, const int32_t* symbols, int64_t n,
                    const int32_t* cdf, int32_t len) {
  auto* e = static_cast<RcEncoder*>(enc);
  const uint32_t total = static_cast<uint32_t>(cdf[len - 1]);
  if (total == 0) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t s = symbols[i];
    if (s < 0 || s >= len - 1) return -1;
    const uint32_t freq = static_cast<uint32_t>(cdf[s + 1] - cdf[s]);
    if (freq == 0) return -2;
    e->encode(static_cast<uint32_t>(cdf[s]), freq, total);
  }
  return 0;
}

// Encode n symbols, each with its own cdf row ([n, row_len] int32).
int hesic_rc_encode_rows(void* enc, const int32_t* symbols, int64_t n,
                         const int32_t* cdf_rows, int32_t row_len) {
  auto* e = static_cast<RcEncoder*>(enc);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* cdf = cdf_rows + static_cast<size_t>(i) * row_len;
    const uint32_t total = static_cast<uint32_t>(cdf[row_len - 1]);
    const int32_t s = symbols[i];
    if (total == 0 || s < 0 || s >= row_len - 1) return -1;
    const uint32_t freq = static_cast<uint32_t>(cdf[s + 1] - cdf[s]);
    if (freq == 0) return -2;
    e->encode(static_cast<uint32_t>(cdf[s]), freq, total);
  }
  return 0;
}

// Flush and copy bytes out.  Returns byte count (or negative required size).
int64_t hesic_rc_encoder_flush(void* enc, uint8_t* out, int64_t out_cap) {
  auto* e = static_cast<RcEncoder*>(enc);
  e->flush();
  const int64_t n = static_cast<int64_t>(e->out.size());
  if (n > out_cap) return -n;
  std::memcpy(out, e->out.data(), n);
  return n;
}

void* hesic_rc_decoder_new(const uint8_t* data, int64_t nbytes) {
  auto* d = new RcDecoder();
  // keep a copy alive alongside the decoder
  auto* buf = new std::vector<uint8_t>(data, data + nbytes);
  d->init(buf->data(), nbytes);
  // stash the buffer pointer right after the decoder (paired free)
  auto* pair = new std::pair<RcDecoder*, std::vector<uint8_t>*>(d, buf);
  return pair;
}

void hesic_rc_decoder_free(void* dec) {
  auto* pair =
      static_cast<std::pair<RcDecoder*, std::vector<uint8_t>*>*>(dec);
  delete pair->first;
  delete pair->second;
  delete pair;
}

int hesic_rc_decode(void* dec, int64_t n, const int32_t* cdf, int32_t len,
                    int32_t* out) {
  auto* pair =
      static_cast<std::pair<RcDecoder*, std::vector<uint8_t>*>*>(dec);
  RcDecoder* d = pair->first;
  const uint32_t total = static_cast<uint32_t>(cdf[len - 1]);
  if (total == 0) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t cf = d->get_freq(total);
    int32_t s = 0;
    while (s + 1 < len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cf) ++s;
    d->advance(static_cast<uint32_t>(cdf[s]),
               static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    out[i] = s;
  }
  return 0;
}

int hesic_rc_decode_rows(void* dec, int64_t n, const int32_t* cdf_rows,
                         int32_t row_len, int32_t* out) {
  auto* pair =
      static_cast<std::pair<RcDecoder*, std::vector<uint8_t>*>*>(dec);
  RcDecoder* d = pair->first;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* cdf = cdf_rows + static_cast<size_t>(i) * row_len;
    const uint32_t total = static_cast<uint32_t>(cdf[row_len - 1]);
    if (total == 0) return -1;
    const uint32_t cf = d->get_freq(total);
    int32_t s = 0;
    while (s + 1 < row_len - 1 && static_cast<uint32_t>(cdf[s + 1]) <= cf) ++s;
    d->advance(static_cast<uint32_t>(cdf[s]),
               static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    out[i] = s;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Autoregressive (PixelCNN-context) coder core
// ---------------------------------------------------------------------------
//
// Runs the raster-causal recursion of the mbt2018/HESIC+ codecs on the host
// with ONE float implementation shared by encode and decode — the recursion's
// Gaussian parameters feed the entropy coder, so encoder and decoder must
// compute bit-identical values (device/host f32 drift corrupts streams).
// Reference semantics: models/priors.py:490-612, newnet1_joint.py:793-1322.

namespace {

struct ArModel {
  int h, w, m, p_dim, q_dim;
  const float* pre;        // (h, w, p_dim)
  const float* post;       // (h, w, q_dim) or nullptr
  const float* k_up;       // (2*5*m, 2m) upper context taps, row-major
  const float* k_left2;    // (m, 2m)
  const float* k_left1;    // (m, 2m)
  const float* ctx_bias;   // (2m)
  const float* w1; const float* b1; int c1_in, c1_mid;
  const float* w2; const float* b2; int c2_mid;
  const float* w3; const float* b3; int c3_out;  // == 2m
  const float* thresholds; int n_thresholds;     // scale_table[:-1]
};

inline void matvec(const float* __restrict w, const float* __restrict x,
                   const float* __restrict bias, int in_dim, int out_dim,
                   float* __restrict out) {
  // w: (in_dim, out_dim) row-major; out = x @ w + bias
  for (int o = 0; o < out_dim; ++o) out[o] = bias ? bias[o] : 0.f;
  for (int i = 0; i < in_dim; ++i) {
    const float xi = x[i];
    if (xi == 0.f) continue;
    const float* wr = w + static_cast<size_t>(i) * out_dim;
    for (int o = 0; o < out_dim; ++o) out[o] += xi * wr[o];
  }
}

inline float leaky(float v) { return v >= 0.f ? v : 0.01f * v; }

// Computes scales/means for pixel (hh, ww) given the padded y_hat buffer
// and the row's precomputed upper context.
void ar_pixel_params(const ArModel& md, const float* y_pad, int w_pad,
                     const float* ctx_up_row, int hh, int ww,
                     std::vector<float>& scratch, float* scales,
                     float* means) {
  const int m = md.m, two_m = 2 * md.m;
  const float* row = y_pad + (static_cast<size_t>(hh + 2) * w_pad) * m;
  scratch.resize(two_m + md.c1_in + md.c1_mid + md.c2_mid + md.c3_out);
  float* ctx = scratch.data();
  float* feat = ctx + two_m;
  float* g1 = feat + md.c1_in;
  float* g2 = g1 + md.c1_mid;
  float* g3 = g2 + md.c2_mid;

  for (int o = 0; o < two_m; ++o)
    ctx[o] = ctx_up_row[static_cast<size_t>(ww) * two_m + o]
             + md.ctx_bias[o];
  matvec(md.k_left2, row + static_cast<size_t>(ww) * m, nullptr, m, two_m,
         g1);  // reuse g1 as temp
  for (int o = 0; o < two_m; ++o) ctx[o] += g1[o];
  matvec(md.k_left1, row + static_cast<size_t>(ww + 1) * m, nullptr, m,
         two_m, g1);
  for (int o = 0; o < two_m; ++o) ctx[o] += g1[o];

  // feat = [pre, ctx, post]
  int fo = 0;
  const float* pre_px = md.pre
      + (static_cast<size_t>(hh) * md.w + ww) * md.p_dim;
  for (int i = 0; i < md.p_dim; ++i) feat[fo++] = pre_px[i];
  for (int i = 0; i < two_m; ++i) feat[fo++] = ctx[i];
  if (md.post) {
    const float* post_px = md.post
        + (static_cast<size_t>(hh) * md.w + ww) * md.q_dim;
    for (int i = 0; i < md.q_dim; ++i) feat[fo++] = post_px[i];
  }
  matvec(md.w1, feat, md.b1, md.c1_in, md.c1_mid, g1);
  for (int i = 0; i < md.c1_mid; ++i) g1[i] = leaky(g1[i]);
  matvec(md.w2, g1, md.b2, md.c1_mid, md.c2_mid, g2);
  for (int i = 0; i < md.c2_mid; ++i) g2[i] = leaky(g2[i]);
  matvec(md.w3, g2, md.b3, md.c2_mid, md.c3_out, g3);
  for (int i = 0; i < m; ++i) scales[i] = g3[i];
  for (int i = 0; i < m; ++i) means[i] = g3[m + i];
}

// Upper-context row: for each ww, taps from the two decoded rows above.
void ar_upper_ctx_row(const ArModel& md, const float* y_pad, int w_pad,
                      int hh, float* ctx_up /* (w, 2m) */) {
  const int m = md.m, two_m = 2 * md.m;
  const int in_dim = 2 * 5 * m;
  std::vector<float> window(in_dim);
  for (int ww = 0; ww < md.w; ++ww) {
    // rows hh..hh+1 of the padded buffer, cols ww..ww+4
    int o = 0;
    for (int dy = 0; dy < 2; ++dy) {
      const float* r = y_pad
          + (static_cast<size_t>(hh + dy) * w_pad + ww) * m;
      for (int dx = 0; dx < 5; ++dx)
        for (int c = 0; c < m; ++c) window[o++] = r[dx * m + c];
    }
    matvec(md.k_up, window.data(), nullptr, in_dim, two_m,
           ctx_up + static_cast<size_t>(ww) * two_m);
  }
}

inline int32_t scale_index(const ArModel& md, float scale) {
  int32_t idx = 0;
  for (int i = 0; i < md.n_thresholds; ++i)
    if (scale > md.thresholds[i]) ++idx;
  return idx;
}

ArModel ar_model_from_args(int h, int w, int m, int p_dim, int q_dim,
                           const float* pre, const float* post,
                           const float* k_up, const float* k_left2,
                           const float* k_left1, const float* ctx_bias,
                           const float* w1, const float* b1, int c1_mid,
                           const float* w2, const float* b2, int c2_mid,
                           const float* w3, const float* b3,
                           const float* thresholds, int n_thresholds) {
  ArModel md;
  md.h = h; md.w = w; md.m = m; md.p_dim = p_dim; md.q_dim = q_dim;
  md.pre = pre; md.post = post;
  md.k_up = k_up; md.k_left2 = k_left2; md.k_left1 = k_left1;
  md.ctx_bias = ctx_bias;
  md.w1 = w1; md.b1 = b1;
  md.c1_in = p_dim + 2 * m + q_dim; md.c1_mid = c1_mid;
  md.w2 = w2; md.b2 = b2; md.c2_mid = c2_mid;
  md.w3 = w3; md.b3 = b3; md.c3_out = 2 * m;
  md.thresholds = thresholds; md.n_thresholds = n_thresholds;
  return md;
}

}  // namespace

extern "C" {

// Shared-argument AR coder.  direction 0 = encode (y given, stream out),
// 1 = decode (stream given, y_hat out).
//   y:        encode: (h, w, m) float latents (input)
//   y_hat:    (h, w, m) float output (decoded/reconstructed latents)
//   stream:   encode: output buffer (cap bytes, returns length or
//             -needed); decode: input buffer (nbytes)
// Weight layouts: k_up (2*5*m, 2m); k_left* (m, 2m); w_i (in, out).
int64_t hesic_ar_code(
    int direction, const float* y, float* y_hat, uint8_t* stream,
    int64_t stream_len, int h, int w, int m, int p_dim, int q_dim,
    const float* pre, const float* post, const float* k_up,
    const float* k_left2, const float* k_left1, const float* ctx_bias,
    const float* w1, const float* b1, int c1_mid, const float* w2,
    const float* b2, int c2_mid, const float* w3, const float* b3,
    const float* thresholds, int n_thresholds, const int32_t* cdfs,
    int32_t cdf_stride, const int32_t* cdf_sizes, const int32_t* offsets,
    int32_t ncdfs) {
  ArModel md = ar_model_from_args(h, w, m, p_dim, q_dim, pre, post, k_up,
                                  k_left2, k_left1, ctx_bias, w1, b1,
                                  c1_mid, w2, b2, c2_mid, w3, b3,
                                  thresholds, n_thresholds);
  const int w_pad = w + 4;
  std::vector<float> y_pad(static_cast<size_t>(h + 4) * w_pad * m, 0.f);
  std::vector<float> ctx_up(static_cast<size_t>(w) * 2 * m);
  std::vector<float> scales(m), means(m), scratch;
  std::vector<int32_t> idx(m), syms(m);

  std::vector<Buffered> enc_buf;
  RansState rans;
  WordSource src{nullptr, nullptr};
  if (direction == 1) {
    if (stream_len < 8 || (stream_len % 4) != 0) return -1;
    src.ptr = reinterpret_cast<const uint32_t*>(stream);
    src.end = reinterpret_cast<const uint32_t*>(stream + stream_len);
    rans_dec_init(rans, src);
  } else {
    enc_buf.reserve(static_cast<size_t>(h) * w * m + 64);
  }

  for (int hh = 0; hh < h; ++hh) {
    ar_upper_ctx_row(md, y_pad.data(), w_pad, hh, ctx_up.data());
    float* out_row = y_pad.data()
        + (static_cast<size_t>(hh + 2) * w_pad + 2) * m;
    for (int ww = 0; ww < w; ++ww) {
      ar_pixel_params(md, y_pad.data(), w_pad, ctx_up.data(), hh, ww,
                      scratch, scales.data(), means.data());
      for (int c = 0; c < m; ++c)
        idx[c] = scale_index(md, scales[c]);
      float* dst = out_row + static_cast<size_t>(ww) * m;
      if (direction == 0) {
        const float* y_px = y
            + (static_cast<size_t>(hh) * w + ww) * m;
        for (int c = 0; c < m; ++c) {
          const float q = std::round(y_px[c] - means[c]);
          dst[c] = q + means[c];
          const int32_t cdf_idx = idx[c];
          if (cdf_idx < 0 || cdf_idx >= ncdfs) return -2;
          buffer_symbol(enc_buf, static_cast<int32_t>(q) - offsets[cdf_idx],
                        cdfs + static_cast<size_t>(cdf_idx) * cdf_stride,
                        cdf_sizes[cdf_idx]);
        }
      } else {
        for (int c = 0; c < m; ++c) {
          const int32_t cdf_idx = idx[c];
          if (cdf_idx < 0 || cdf_idx >= ncdfs) return -2;
          const int32_t v = decode_symbol(
              rans, src, cdfs + static_cast<size_t>(cdf_idx) * cdf_stride,
              cdf_sizes[cdf_idx]) + offsets[cdf_idx];
          dst[c] = static_cast<float>(v) + means[c];
        }
      }
    }
  }

  // copy the interior of the padded buffer to y_hat
  for (int hh = 0; hh < h; ++hh) {
    const float* src_row = y_pad.data()
        + (static_cast<size_t>(hh + 2) * w_pad + 2) * m;
    std::memcpy(y_hat + (static_cast<size_t>(hh) * w) * m, src_row,
                sizeof(float) * static_cast<size_t>(w) * m);
  }

  if (direction == 0) {
    return flush_buffer(enc_buf, stream, stream_len);
  }
  return 0;
}

}  // extern "C"
