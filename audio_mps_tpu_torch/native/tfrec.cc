// Native data-plane for the TFRecord engine: CRC32C (slice-by-8) and a
// zero-allocation wire-format scanner that extracts the `audio` float_list
// from a serialized tf.train.Example. This is the C++ runtime layer behind
// audio_mps_tpu_torch/data/tfrecord.py (the reference delegates all of
// this to the TensorFlow C++ runtime; here it is a ~200-line
// dependency-free library loaded via ctypes). A copy of the JAX package's
// native/tfrec.cc.
//
// Built on first use by native/__init__.py (g++ -O3 -shared -fPIC).

#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <cstring>

namespace {

constexpr uint32_t kCrcPoly = 0x82F63B78u;  // Castagnoli, reflected

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ ((crc & 1) ? kCrcPoly : 0);
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int j = 1; j < 8; ++j)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};

const CrcTables kTables;

uint32_t crc32c_impl(const uint8_t* p, size_t n, uint32_t crc0) {
  uint32_t crc = crc0 ^ 0xFFFFFFFFu;
  // 8-byte slices
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    word ^= crc;  // little-endian host assumed (x86/arm64)
    crc = kTables.t[7][word & 0xFF] ^
          kTables.t[6][(word >> 8) & 0xFF] ^
          kTables.t[5][(word >> 16) & 0xFF] ^
          kTables.t[4][(word >> 24) & 0xFF] ^
          kTables.t[3][(word >> 32) & 0xFF] ^
          kTables.t[2][(word >> 40) & 0xFF] ^
          kTables.t[1][(word >> 48) & 0xFF] ^
          kTables.t[0][(word >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kTables.t[0][(crc ^ *p++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

// --- minimal protobuf wire scanning -------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  bool advance(uint64_t n) {
    // validate BEFORE pointer arithmetic: a malformed varint length can
    // otherwise wrap the pointer past `end` (UB + OOB reads)
    if (!ok || n > size_t(end - p)) return ok = false;
    p += n;
    return true;
  }

  bool skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); return ok;
      case 1: return advance(8);
      case 2: {
        uint64_t len = varint();
        return ok && advance(len);
      }
      case 5: return advance(4);
      default: return ok = false;
    }
  }
};

// Find a length-delimited subfield `field` inside [p, p+len); returns its
// payload span or {nullptr, 0}.
bool find_field(const uint8_t* p, size_t len, uint32_t field,
                const uint8_t** out, size_t* out_len, const uint8_t* start_at
                = nullptr) {
  Cursor c{start_at ? start_at : p, p + len};
  while (c.ok && c.p < c.end) {
    uint64_t tag = c.varint();
    if (!c.ok) return false;
    uint32_t f = uint32_t(tag >> 3), wire = uint32_t(tag & 7);
    if (f == field && wire == 2) {
      uint64_t flen = c.varint();
      if (!c.ok || flen > size_t(c.end - c.p)) return false;
      *out = c.p;
      *out_len = size_t(flen);
      return true;
    }
    if (!c.skip(wire)) return false;
  }
  return false;
}

}  // namespace

extern "C" {

uint32_t amt_crc32c(const uint8_t* data, size_t len) {
  return crc32c_impl(data, len, 0);
}

uint32_t amt_masked_crc(const uint8_t* data, size_t len) {
  uint32_t crc = crc32c_impl(data, len, 0);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// Extract the packed float payload of Example.features.feature["<name>"]
// .float_list.value into out (at most out_cap floats). Returns the number
// of floats written, or -1 if the feature is absent/malformed. If out is
// null, returns the float count without copying.
long amt_parse_float_feature(const uint8_t* rec, size_t len,
                             const char* name, float* out, size_t out_cap) {
  const uint8_t* features;
  size_t features_len;
  // Example.features = field 1
  if (!find_field(rec, len, 1, &features, &features_len)) return -1;

  size_t name_len = std::strlen(name);
  Cursor c{features, features + features_len};
  while (c.ok && c.p < c.end) {
    uint64_t tag = c.varint();
    if (!c.ok) return -1;
    uint32_t f = uint32_t(tag >> 3), wire = uint32_t(tag & 7);
    if (f == 1 && wire == 2) {  // Features.feature map entry
      uint64_t elen = c.varint();
      if (!c.ok || elen > size_t(c.end - c.p)) return -1;
      const uint8_t* entry = c.p;
      c.p += elen;
      // map entry: key = field 1 (string), value = field 2 (Feature)
      const uint8_t* key;
      size_t key_len;
      if (!find_field(entry, size_t(elen), 1, &key, &key_len)) continue;
      if (key_len != name_len || std::memcmp(key, name, name_len) != 0)
        continue;
      const uint8_t* feat;
      size_t feat_len;
      if (!find_field(entry, size_t(elen), 2, &feat, &feat_len)) return -1;
      // Feature.float_list = field 2
      const uint8_t* flist;
      size_t flist_len;
      if (!find_field(feat, feat_len, 2, &flist, &flist_len)) return -1;
      // FloatList.value = field 1; protobuf allows any mix of packed
      // (wire 2) runs and unpacked (wire 5) scalars — concatenate all
      Cursor fc{flist, flist + flist_len};
      size_t n = 0;
      while (fc.ok && fc.p < fc.end) {
        uint64_t tag = fc.varint();
        if (!fc.ok) return -1;
        uint32_t ff = uint32_t(tag >> 3), fw = uint32_t(tag & 7);
        if (ff == 1 && fw == 2) {
          uint64_t len = fc.varint();
          if (!fc.ok || len > size_t(fc.end - fc.p)) return -1;
          size_t cnt = size_t(len) / 4;
          if (out != nullptr) {
            size_t take = (n < out_cap) ? std::min(cnt, out_cap - n) : 0;
            std::memcpy(out + n, fc.p, take * 4);
          }
          n += cnt;
          fc.advance(len);
        } else if (ff == 1 && fw == 5) {
          if (size_t(fc.end - fc.p) < 4) return -1;  // before the memcpy
          if (out != nullptr && n < out_cap)
            std::memcpy(out + n, fc.p, 4);
          fc.advance(4);
          n += 1;
        } else if (!fc.skip(fw)) {
          return -1;
        }
      }
      return long(n);
    }
    if (!c.skip(wire)) return -1;
  }
  return -1;
}

}  // extern "C"
