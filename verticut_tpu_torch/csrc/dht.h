// Host-resident cuckoo-hash key-value store with self-verifying rows.
//
// The native KV subsystem of the framework — the role Pilaf's RDMA DHT
// plays in the reference (Pilaf/dht.h: d-ary cuckoo table, CRC-guarded rows,
// separate extents region with a power-of-two allocator, resize-on-full).
// Independent design and implementation; shared properties that matter for
// behavioral parity:
//   * 3 Murmur64A hash functions with the reference's seeds (integrity.h),
//     so key -> candidate-slot placement is reproducible;
//   * every slot carries a guard CRC of its metadata and every key/value
//     blob a trailing CRC of its bytes, so a reader that races a writer
//     observes a checksum mismatch instead of torn data (the reference's
//     lock-free-reader protocol, Pilaf/dht.h:637-674);
//   * writers invalidate the blob CRC before freeing/moving it
//     (Pilaf/dht.h:480-481,517-518).
//
// Single-writer. Readers may share the memory (e.g. over shm) and use the
// CRC protocol; the in-process API validates CRCs on every get as a
// self-check.
#ifndef VERTICUT_NATIVE_DHT_H_
#define VERTICUT_NATIVE_DHT_H_

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "integrity.h"

namespace verticut {

class Dht {
 public:
  static constexpr int kWays = 3;            // cuckoo arity
  static constexpr int kMaxKicks = 128;      // displacement walk bound
  static constexpr uint64_t kMinBlob = 16;   // smallest arena size class

  struct Stats {
    uint64_t puts = 0, gets = 0, removes = 0;
    uint64_t probes = 0, kicks = 0, resizes = 0, crc_failures = 0;
  };

  explicit Dht(uint64_t n_slots = 1024, uint64_t arena_bytes = 1 << 20)
      : slots_(RoundPow2(n_slots < 8 ? 8 : n_slots)),
        arena_(RoundPow2(arena_bytes < 4096 ? 4096 : arena_bytes)),
        free_lists_(64) {}

  // ---- public API --------------------------------------------------------

  // Returns 0 on success.
  int Put(const void* key, uint32_t klen, const void* val, uint32_t vlen) {
    stats_.puts++;
    uint64_t idx;
    if (Find(key, klen, &idx)) {  // replace value in place
      Slot& s = slots_[idx];
      uint64_t blob = AllocBlob(klen, vlen);
      WriteBlob(blob, key, klen, val, vlen);
      uint64_t old = s.data_off;
      uint32_t old_k = s.key_len, old_v = s.val_len;
      s.data_off = blob;
      s.val_len = vlen;
      Reseal(s);
      FreeBlob(old, old_k, old_v);
      return 0;
    }
    return Insert(key, klen, val, vlen);
  }

  // Returns value length, copying min(vlen, cap) bytes into out;
  // -1 if absent.
  int64_t Get(const void* key, uint32_t klen, void* out, uint64_t cap) {
    stats_.gets++;
    uint64_t idx;
    if (!Find(key, klen, &idx)) return -1;
    const Slot& s = slots_[idx];
    if (!CheckBlob(s)) {  // torn data: report as transient failure
      stats_.crc_failures++;
      return -2;
    }
    uint64_t n = s.val_len < cap ? s.val_len : cap;
    std::memcpy(out, arena_.data() + s.data_off + s.key_len, n);
    return static_cast<int64_t>(s.val_len);
  }

  bool Contains(const void* key, uint32_t klen) {
    uint64_t idx;
    return Find(key, klen, &idx);
  }

  int Remove(const void* key, uint32_t klen) {
    stats_.removes++;
    uint64_t idx;
    if (!Find(key, klen, &idx)) return -1;
    Slot& s = slots_[idx];
    // invalidate blob CRC before freeing so concurrent readers fail fast
    CorruptBlobCrc(s);
    FreeBlob(s.data_off, s.key_len, s.val_len);
    s = Slot{};
    count_--;
    return 0;
  }

  uint64_t Count() const { return count_; }
  uint64_t Capacity() const { return slots_.size(); }
  const Stats& GetStats() const { return stats_; }

 private:
  struct Slot {
    uint64_t data_off = 0;
    uint32_t key_len = 0;
    uint32_t val_len = 0;
    uint64_t key_hash = 0;   // Murmur(seed 0) of the key: cheap pre-filter
    uint8_t in_use = 0;
    uint8_t hash_id = 0;
    uint8_t pad_[6] = {0};
    uint64_t guard = 0;      // CRC of all fields above
  };

  static uint64_t RoundPow2(uint64_t x) {
    uint64_t p = 1;
    while (p < x) p <<= 1;
    return p;
  }

  uint64_t SlotIndex(const void* key, uint32_t klen, int way) const {
    stats_.probes++;
    return Integrity::HashN(key, klen, way) & (slots_.size() - 1);
  }

  uint64_t GuardOf(const Slot& s) const {
    return integ_.Crc(&s, offsetof(Slot, guard));
  }

  void Reseal(Slot& s) { s.guard = GuardOf(s); }

  bool Find(const void* key, uint32_t klen, uint64_t* out_idx) {
    uint64_t h0 = Integrity::HashN(key, klen, 0);
    for (int w = 0; w < kWays; ++w) {
      uint64_t idx = SlotIndex(key, klen, w);
      const Slot& s = slots_[idx];
      if (!s.in_use || s.key_len != klen || s.key_hash != h0) continue;
      if (s.guard != GuardOf(s)) {
        stats_.crc_failures++;
        continue;
      }
      if (std::memcmp(arena_.data() + s.data_off, key, klen) == 0) {
        *out_idx = idx;
        return true;
      }
    }
    return false;
  }

  int Insert(const void* key, uint32_t klen, const void* val, uint32_t vlen) {
    uint64_t blob = AllocBlob(klen, vlen);
    WriteBlob(blob, key, klen, val, vlen);
    Slot cand{};
    cand.data_off = blob;
    cand.key_len = klen;
    cand.val_len = vlen;
    cand.key_hash = Integrity::HashN(key, klen, 0);
    cand.in_use = 1;
    while (true) {
      if (TryPlace(&cand)) {
        count_++;
        return 0;
      }
      Grow();
    }
  }

  // Cuckoo placement with bounded displacement walk; cand's key bytes are
  // at arena[cand.data_off..+key_len].
  bool TryPlace(Slot* cand) {
    for (int kick = 0; kick < kMaxKicks; ++kick) {
      const uint8_t* kb = arena_.data() + cand->data_off;
      // any empty way?
      for (int w = 0; w < kWays; ++w) {
        uint64_t idx = SlotIndex(kb, cand->key_len, w);
        if (!slots_[idx].in_use) {
          cand->hash_id = static_cast<uint8_t>(w);
          slots_[idx] = *cand;
          Reseal(slots_[idx]);
          return true;
        }
      }
      // displace the occupant of a pseudo-random way (unsigned arithmetic:
      // a negative % would select hash seed 3, which Find never probes)
      stats_.kicks++;
      int w = static_cast<int>(
          (static_cast<uint32_t>(cand->key_hash) + kick) % kWays);
      uint64_t idx = SlotIndex(kb, cand->key_len, w);
      Slot victim = slots_[idx];
      cand->hash_id = static_cast<uint8_t>(w);
      slots_[idx] = *cand;
      Reseal(slots_[idx]);
      *cand = victim;
    }
    return false;
  }

  void Grow() {
    stats_.resizes++;
    // Snapshot live rows, then rebuild into ever-larger tables until every
    // row places. A failed displacement walk leaves its last victim in the
    // walk's local copy, not the table, so rebuilding from the snapshot
    // loses nothing.
    std::vector<Slot> pending;
    pending.reserve(count_);
    for (const Slot& s : slots_) {
      if (s.in_use) pending.push_back(s);
    }
    uint64_t n = slots_.size() * 2;
    for (;;) {
      slots_.assign(n, Slot{});
      bool ok = true;
      for (const Slot& s : pending) {
        Slot cand = s;
        if (!TryPlace(&cand)) {
          ok = false;
          break;
        }
      }
      if (ok) return;
      n <<= 1;
    }
  }

  // ---- arena: power-of-two free-list allocator ---------------------------

  static int SizeClass(uint64_t n) {
    uint64_t need = n < kMinBlob ? kMinBlob : n;
    int c = 0;
    uint64_t s = 1;
    while (s < need) {
      s <<= 1;
      ++c;
    }
    return c;
  }

  uint64_t BlobBytes(uint32_t klen, uint32_t vlen) const {
    return static_cast<uint64_t>(klen) + vlen + 8;  // +8: trailing CRC
  }

  uint64_t AllocBlob(uint32_t klen, uint32_t vlen) {
    int c = SizeClass(BlobBytes(klen, vlen));
    if (!free_lists_[c].empty()) {
      uint64_t off = free_lists_[c].back();
      free_lists_[c].pop_back();
      return off;
    }
    uint64_t sz = 1ULL << c;
    if (arena_top_ + sz > arena_.size()) {
      uint64_t target = arena_.size();
      while (arena_top_ + sz > target) target <<= 1;
      arena_.resize(target);
    }
    uint64_t off = arena_top_;
    arena_top_ += sz;
    return off;
  }

  void FreeBlob(uint64_t off, uint32_t klen, uint32_t vlen) {
    free_lists_[SizeClass(BlobBytes(klen, vlen))].push_back(off);
  }

  void WriteBlob(uint64_t off, const void* key, uint32_t klen,
                 const void* val, uint32_t vlen) {
    uint8_t* p = arena_.data() + off;
    std::memcpy(p, key, klen);
    std::memcpy(p + klen, val, vlen);
    uint64_t crc = integ_.Crc(p, klen + vlen);
    std::memcpy(p + klen + vlen, &crc, 8);
  }

  bool CheckBlob(const Slot& s) const {
    const uint8_t* p = arena_.data() + s.data_off;
    uint64_t stored;
    std::memcpy(&stored, p + s.key_len + s.val_len, 8);
    return stored == integ_.Crc(p, s.key_len + s.val_len);
  }

  void CorruptBlobCrc(Slot& s) {
    uint8_t* p = arena_.data() + s.data_off + s.key_len + s.val_len;
    p[0] ^= 0xFF;
  }

  Integrity integ_;
  std::vector<Slot> slots_;
  std::vector<uint8_t> arena_;
  std::vector<std::vector<uint64_t>> free_lists_;
  uint64_t arena_top_ = 0;
  uint64_t count_ = 0;
  mutable Stats stats_;
};

}  // namespace verticut

#endif  // VERTICUT_NATIVE_DHT_H_
