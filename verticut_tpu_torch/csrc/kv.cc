// C interface of the host key-value store: the cuckoo-hash DHT (dht.h) and
// the integrity primitives it hashes and checks with (integrity.h).
//
// The port's copy of the JAX package's store surface
// (verticut_tpu/native/src/dht_capi.cc, and vt_crc64 / vt_murmur64 /
// vt_hash_n of builder.cc), built with the host compiler by
// kernels/_build.py and loaded with ctypes by verticut_tpu_torch/kv/native.py.
// dht.h and integrity.h are verbatim copies, so a key lands in the same
// slots and the store counts the same probes, kicks and resizes as the JAX
// package's for the same operations.

#include <cstdint>

#include "dht.h"
#include "integrity.h"

using verticut::Dht;

extern "C" {

void* vt_dht_create(uint64_t n_slots, uint64_t arena_bytes) {
  return new Dht(n_slots, arena_bytes);
}

void vt_dht_destroy(void* h) { delete static_cast<Dht*>(h); }

int vt_dht_put(void* h, const void* key, uint32_t klen, const void* val,
               uint32_t vlen) {
  return static_cast<Dht*>(h)->Put(key, klen, val, vlen);
}

int64_t vt_dht_get(void* h, const void* key, uint32_t klen, void* out,
                   uint64_t cap) {
  return static_cast<Dht*>(h)->Get(key, klen, out, cap);
}

int vt_dht_contains(void* h, const void* key, uint32_t klen) {
  return static_cast<Dht*>(h)->Contains(key, klen) ? 1 : 0;
}

int vt_dht_remove(void* h, const void* key, uint32_t klen) {
  return static_cast<Dht*>(h)->Remove(key, klen);
}

uint64_t vt_dht_count(void* h) { return static_cast<Dht*>(h)->Count(); }

uint64_t vt_dht_capacity(void* h) { return static_cast<Dht*>(h)->Capacity(); }

// out[7]: puts, gets, removes, probes, kicks, resizes, crc_failures
void vt_dht_stats(void* h, uint64_t* out) {
  const Dht::Stats& s = static_cast<Dht*>(h)->GetStats();
  out[0] = s.puts;
  out[1] = s.gets;
  out[2] = s.removes;
  out[3] = s.probes;
  out[4] = s.kicks;
  out[5] = s.resizes;
  out[6] = s.crc_failures;
}

uint64_t vt_crc64(const void* data, uint64_t len) {
  static verticut::Integrity integ;
  return integ.Crc(data, len);
}

uint64_t vt_murmur64(const void* data, uint64_t len, uint64_t seed) {
  return verticut::Integrity::Murmur64A(data, len, seed);
}

// Murmur64A under the n-th of the reference's four seeds: 0-2 place a key
// in the cuckoo table, 3 picks its server shard.
uint64_t vt_hash_n(const void* data, uint64_t len, int n) {
  return verticut::Integrity::HashN(data, len, n);
}

}  // extern "C"
