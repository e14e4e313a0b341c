// Integrity primitives: table-driven CRC-64 and MurmurHash64A.
//
// Same algorithm family and constants as the reference KV store
// (Pilaf/integrity.h: CRC poly 0x42F0E1EBA9EA3693 / ECMA-182 variant with
// init 0x0060034000F0D50B, and MurmurHash64A with four fixed seeds) so that
// key placement and checksum values are reproducible against data produced
// by the reference. Both algorithms are public standards; this is an
// independent implementation.
#ifndef VERTICUT_NATIVE_INTEGRITY_H_
#define VERTICUT_NATIVE_INTEGRITY_H_

#include <cstddef>
#include <cstdint>

namespace verticut {

inline constexpr uint64_t kCrcPoly = 0x42F0E1EBA9EA3693ULL;
inline constexpr uint64_t kCrcInit = 0x0060034000F0D50BULL;

// The d cuckoo-hash seeds (0..2) and the server-shard seed (3), matching
// Pilaf/integrity.h:31-34 for placement parity.
inline constexpr uint64_t kHashSeeds[4] = {
    0x199999999999997FULL, 0x1999999999999990ULL,
    0x01000193ULL, 0x0100019DULL};

class Integrity {
 public:
  Integrity() {
    for (uint32_t i = 0; i < 256; ++i) {
      // MSB-first table construction for the given polynomial.
      uint64_t acc = 0;
      uint64_t bits = static_cast<uint64_t>(i);
      for (int b = 0; b < 8; ++b, bits <<= 1) {
        acc <<= 1;
        if (bits & 0x80u) acc ^= kCrcPoly;
      }
      table_[i] = acc;
    }
  }

  uint64_t Crc(const void* data, size_t len) const {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    uint64_t h = kCrcInit;
    for (size_t i = 0; i < len; ++i) {
      h = table_[static_cast<uint8_t>(h ^ p[i])] ^ (h >> 8);
    }
    return h;
  }

  static uint64_t Murmur64A(const void* key, size_t len, uint64_t seed) {
    constexpr uint64_t kMul = 0xc6a4a7935bd1e995ULL;
    constexpr int kShift = 47;
    const uint8_t* p = static_cast<const uint8_t*>(key);
    uint64_t h = seed ^ (static_cast<uint64_t>(len) * kMul);
    size_t nblocks = len / 8;
    for (size_t i = 0; i < nblocks; ++i) {
      uint64_t k;
      __builtin_memcpy(&k, p + i * 8, 8);
      k *= kMul;
      k ^= k >> kShift;
      k *= kMul;
      h ^= k;
      h *= kMul;
    }
    const uint8_t* tail = p + nblocks * 8;
    uint64_t t = 0;
    switch (len & 7u) {
      case 7: t ^= static_cast<uint64_t>(tail[6]) << 48; [[fallthrough]];
      case 6: t ^= static_cast<uint64_t>(tail[5]) << 40; [[fallthrough]];
      case 5: t ^= static_cast<uint64_t>(tail[4]) << 32; [[fallthrough]];
      case 4: t ^= static_cast<uint64_t>(tail[3]) << 24; [[fallthrough]];
      case 3: t ^= static_cast<uint64_t>(tail[2]) << 16; [[fallthrough]];
      case 2: t ^= static_cast<uint64_t>(tail[1]) << 8;  [[fallthrough]];
      case 1:
        t ^= static_cast<uint64_t>(tail[0]);
        h ^= t;
        h *= kMul;
        break;
      default:
        break;
    }
    h ^= h >> kShift;
    h *= kMul;
    h ^= h >> kShift;
    return h;
  }

  static uint64_t HashN(const void* key, size_t len, int n) {
    return Murmur64A(key, len, kHashSeeds[n & 3]);
  }

 private:
  uint64_t table_[256];
};

}  // namespace verticut

#endif  // VERTICUT_NATIVE_INTEGRITY_H_
