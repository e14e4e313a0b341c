"""The key-value store seam (port of ``verticut_tpu/kv``): pluggable
stores behind the reference's ``BaseProxy`` contract, the typed bucket
schema, the op log, and the RESP2 and memcached connectors with the
standalone RESP2 store server. Host code: the native store is
``csrc/kv.cc`` (:mod:`.native`)."""

from verticut_tpu_torch.kv.store import (  # noqa: F401
    BucketStore, DHTStore, KVStore, MemoryKV, OpLogKV, ShardedKV, make_store)
from verticut_tpu_torch.kv.remote import (KVServer, MemcachedKV,  # noqa: F401
                                          RedisKV)
