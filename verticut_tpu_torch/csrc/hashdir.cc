// Cuckoo hash directory builder: substring value -> (start, count) rows.
//
// The port's copy of the JAX package's host builder
// (verticut_tpu/native/src/hashdir.cc), built with the host compiler by
// kernels/_build.py and loaded with ctypes. The directory is laid out as
// 16-byte rows [key, start, count, pad], one gathered row per probe, with
// 2-way cuckoo hashing: every lookup costs exactly two independent row
// gathers (vs ~10 dependent gathers for a bisection chain).
//
// Host-side build (cuckoo insertion is inherently sequential); consumed by
// verticut_tpu_torch/index/directory.py::HashDirectory.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Avalanche mixers (murmur3-finalizer shape). A plain multiply-shift hash
// is linear: keys that differ by the same XOR delta land in slots that
// differ by the same delta, and MIH substrings are exactly such families
// (cluster center ^ few bit flips) — dense enough to wedge cuckoo
// insertion at <30% load. The xorshift stages break the linearity.
// The device lookup evaluates the identical function — see
// index/directory.py::_mix (constants must match).
constexpr uint32_t kC1a = 0x85EBCA6Bu, kC1b = 0xC2B2AE35u;  // murmur3 fmix
constexpr uint32_t kC2a = 0x7FEB352Du, kC2b = 0x846CA68Bu;  // lowbias32

inline uint32_t Mix(uint32_t v, uint32_t ca, uint32_t cb) {
  v ^= v >> 16;
  v *= ca;
  v ^= v >> 13;
  v *= cb;
  v ^= v >> 16;
  return v;
}

inline uint32_t Slot1(uint32_t v, uint64_t mask) {
  return Mix(v, kC1a, kC1b) & static_cast<uint32_t>(mask);
}
inline uint32_t Slot2(uint32_t v, uint64_t mask) {
  return Mix(v, kC2a, kC2b) & static_cast<uint32_t>(mask);
}

}  // namespace

extern "C" {

// Input: the sorted substring column (with duplicates). Emits the cuckoo
// row table as 4 x uint32 per slot: [key, start, count, 0]. `table` must
// hold 4 * n_slots uint32s, n_slots a power of two chosen by the caller;
// returns 0 on success, -1 if the table could not be built at this size
// (caller doubles and retries), -2 on bad args.
int vt_build_hashdir(const uint32_t* sorted_keys, uint64_t n,
                     uint64_t n_slots, uint32_t* table) {
  if (n_slots == 0 || (n_slots & (n_slots - 1)) != 0) return -2;
  const uint64_t mask = n_slots - 1;
  std::memset(table, 0, n_slots * 4 * sizeof(uint32_t));
  // empty slot: count == 0 (a real row always has count >= 1, and a key
  // match with count 0 reads as a miss, so key=0 in empty slots is safe)

  const int kMaxKicks = 256;
  uint64_t i = 0;
  while (i < n) {
    // unique run [i, j)
    uint64_t j = i + 1;
    while (j < n && sorted_keys[j] == sorted_keys[i]) ++j;
    uint32_t key = sorted_keys[i];
    uint32_t start = static_cast<uint32_t>(i);
    uint32_t count = static_cast<uint32_t>(j - i);
    // canonical cuckoo walk: place in an empty way if any; otherwise evict
    // and move each victim to its *alternate* slot (never back where it
    // came from — an alternating-eviction policy ping-pongs and fails at
    // <30% load)
    uint32_t s1 = Slot1(key, mask);
    uint32_t s2 = Slot2(key, mask);
    uint32_t target = (table[4ull * s1 + 2] == 0) ? s1
                      : (table[4ull * s2 + 2] == 0) ? s2 : s1;
    int kicks = 0;
    bool placed = false;
    while (!placed) {
      uint32_t* row = table + 4ull * target;
      uint32_t vk = row[0], vs = row[1], vc = row[2];
      bool was_empty = (vc == 0);
      row[0] = key; row[1] = start; row[2] = count;
      if (was_empty) {
        placed = true;
        break;
      }
      // victim moves to its alternate slot
      uint32_t v1 = Slot1(vk, mask);
      target = (v1 == target) ? Slot2(vk, mask) : v1;
      key = vk; start = vs; count = vc;
      if (++kicks > kMaxKicks) return -1;
    }
    i = j;
  }
  return 0;
}

}  // extern "C"
