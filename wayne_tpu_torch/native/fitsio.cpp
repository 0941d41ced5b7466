// Native FITS ima-output backend of wayne_tpu_torch (its own copy of the
// JAX package's wayne_tpu/native/fitsio.cpp, the same C ABI and ABI tag).
//
// The byte-level work of an ima product -- big-endian conversion of every
// SCI plane, on-the-fly ERR (shot + read noise) propagation, DQ/SAMP/TIME
// plane synthesis and 2880-byte padding -- runs in C++; the headers are
// rendered by the Python layer (wayne_tpu_torch/io/ima.py, cheap and
// string-heavy). Exposed as a plain C ABI for ctypes.
//
// Built at first use by wayne_tpu_torch/io/native.py:
//   g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared
// (no -march=native: the library must run on whichever host loads it, and
// no contraction, so ERR rounds as the plain arithmetic below says).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr long kBlock = 2880;

inline uint32_t bswap32(uint32_t v) {
#if defined(__GNUC__)
  return __builtin_bswap32(v);
#else
  return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
         ((v >> 24) & 0xFF);
#endif
}

inline uint16_t bswap16(uint16_t v) { return (uint16_t)((v << 8) | (v >> 8)); }

// Buffered big-endian plane writers ------------------------------------

int write_padded(FILE* f, const void* data, long nbytes) {
  if (fwrite(data, 1, (size_t)nbytes, f) != (size_t)nbytes) return -1;
  long rem = (kBlock - (nbytes % kBlock)) % kBlock;
  if (rem) {
    static const char zeros[kBlock] = {0};
    if (fwrite(zeros, 1, (size_t)rem, f) != (size_t)rem) return -1;
  }
  return 0;
}

int write_f32_be(FILE* f, const float* src, long n, std::vector<uint32_t>& buf) {
  buf.resize((size_t)n);
  // memcpy, not reinterpret_cast-and-deref: reading float storage
  // through a uint32_t* is a strict-aliasing violation that -O3 is
  // licensed to miscompile; memcpy lowers to the same single load.
  for (long i = 0; i < n; ++i) {
    uint32_t raw;
    std::memcpy(&raw, src + i, 4);
    buf[(size_t)i] = bswap32(raw);
  }
  return write_padded(f, buf.data(), n * 4);
}

int write_const_f32_be(FILE* f, float value, long n, std::vector<uint32_t>& buf) {
  uint32_t raw;
  std::memcpy(&raw, &value, 4);
  raw = bswap32(raw);
  buf.assign((size_t)n, raw);
  return write_padded(f, buf.data(), n * 4);
}

int write_const_i16_be(FILE* f, int16_t value, long n, std::vector<uint16_t>& buf16) {
  uint16_t raw = bswap16((uint16_t)value);
  buf16.assign((size_t)n, raw);
  return write_padded(f, buf16.data(), n * 2);
}

int write_i16_be(FILE* f, const int16_t* src, long n, std::vector<uint16_t>& buf16) {
  buf16.resize((size_t)n);
  for (long i = 0; i < n; ++i) {
    uint16_t raw;
    std::memcpy(&raw, src + i, 2);
    buf16[(size_t)i] = bswap16(raw);
  }
  return write_padded(f, buf16.data(), n * 2);
}

}  // namespace

extern "C" {

// Writes one ima-style exposure.
//
//   path          output file
//   primary_hdr   pre-rendered, pre-padded primary header bytes
//   ext_hdrs      5*nr pre-rendered, pre-padded extension headers in FILE
//                 order (reverse time: last read first; per read the order
//                 is SCI, ERR, DQ, SAMP, TIME)
//   ext_hdr_lens  lengths of each entry in ext_hdrs
//   reads         (nr, h, w) float32, TIME order (read 0 first)
//   read_times    (nr,) seconds
//   gain          e-/DN; read_noise in e-.
//   bias_dn       zeroth-read pedestal (DN) subtracted before the shot-
//                 noise term so ERR covers source+sky+dark Poisson charge
//                 plus read noise, but not the non-Poissonian bias.
//   gain_map      optional (h, w) per-pixel gain (e-/DN) plane: when the
//                 simulator wrote SCI through per-pixel gain variations,
//                 ERR must propagate through the same map or the
//                 quadrant gain structure leaks into the shot term.
//                 NULL -> scalar gain.
//   bias_e_map    optional (h, w) per-pixel bias pedestal (ELECTRONS);
//                 NULL -> the scalar bias_dn * gain convention.
//
// Returns 0 on success, negative errno-style code on failure.
// ``dq`` is optional: (nr, h, w) int16 planes in TIME order, or NULL for
// all-zero DQ.
int wayne_write_ima(const char* path, const uint8_t* primary_hdr,
                    long primary_len, const uint8_t* const* ext_hdrs,
                    const long* ext_hdr_lens, const float* reads,
                    const int16_t* dq, long nr, long h, long w,
                    const double* read_times, float gain,
                    float read_noise, float bias_dn,
                    const float* gain_map, const float* bias_e_map) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);

  const long n = h * w;
  std::vector<uint32_t> buf;
  std::vector<uint16_t> buf16;
  std::vector<float> err((size_t)n);
  int rc = 0;

  if (fwrite(primary_hdr, 1, (size_t)primary_len, f) != (size_t)primary_len)
    rc = -2;

  const float rn2 = read_noise * read_noise;
  const float inv_gain = 1.0f / gain;
  long ext = 0;
  for (long k = nr - 1; k >= 0 && rc == 0; --k) {
    const float* sci = reads + k * n;
    // SCI
    if (fwrite(ext_hdrs[ext], 1, (size_t)ext_hdr_lens[ext], f) !=
        (size_t)ext_hdr_lens[ext]) { rc = -3; break; }
    ++ext;
    if (write_f32_be(f, sci, n, buf)) { rc = -4; break; }
    // ERR = sqrt(max(sci*g - bias_e, 0) + rn^2) / g per pixel: Poisson
    // term covers accumulated source+sky+dark charge (all in the
    // measured DN), with the non-Poissonian bias pedestal removed. g is
    // the per-pixel gain map when given, else the scalar gain.
    if (gain_map || bias_e_map) {
      const float bias_e_scalar = bias_dn * gain;
      for (long i = 0; i < n; ++i) {
        const float g = gain_map ? gain_map[i] : gain;
        const float be = bias_e_map ? bias_e_map[i] : bias_e_scalar;
        float se = sci[i] * g - be;
        if (se < 0.0f) se = 0.0f;
        err[(size_t)i] = std::sqrt(se + rn2) / g;
      }
    } else {
      for (long i = 0; i < n; ++i) {
        float s = sci[i] - bias_dn;
        if (s < 0.0f) s = 0.0f;
        err[(size_t)i] = std::sqrt(s * gain + rn2) * inv_gain;
      }
    }
    if (fwrite(ext_hdrs[ext], 1, (size_t)ext_hdr_lens[ext], f) !=
        (size_t)ext_hdr_lens[ext]) { rc = -5; break; }
    ++ext;
    if (write_f32_be(f, err.data(), n, buf)) { rc = -6; break; }
    // DQ
    if (fwrite(ext_hdrs[ext], 1, (size_t)ext_hdr_lens[ext], f) !=
        (size_t)ext_hdr_lens[ext]) { rc = -7; break; }
    ++ext;
    if (dq ? write_i16_be(f, dq + k * n, n, buf16)
           : write_const_i16_be(f, 0, n, buf16)) { rc = -8; break; }
    // SAMP (int16, read index)
    if (fwrite(ext_hdrs[ext], 1, (size_t)ext_hdr_lens[ext], f) !=
        (size_t)ext_hdr_lens[ext]) { rc = -9; break; }
    ++ext;
    if (write_const_i16_be(f, (int16_t)k, n, buf16)) { rc = -10; break; }
    // TIME (float32, sample time)
    if (fwrite(ext_hdrs[ext], 1, (size_t)ext_hdr_lens[ext], f) !=
        (size_t)ext_hdr_lens[ext]) { rc = -11; break; }
    ++ext;
    if (write_const_f32_be(f, (float)read_times[k], n, buf)) { rc = -12; break; }
  }

  if (fclose(f) != 0 && rc == 0) rc = -13;
  return rc;
}

// ABI tag checked by the ctypes loader (wayne_tpu_torch/io/native.py): a
// library built from another source must be refused, not called. Bump
// together with _ABI_VERSION when the signature of wayne_write_ima
// changes.
int wayne_abi_version(void) { return 3; }

}  // extern "C"
