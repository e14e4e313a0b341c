"""The msgpack-RPC search service on the port's engine: the port's copy of
``verticut_tpu/service`` (server, pooled client, replica fan-out), on its
own msgpack subset (:mod:`.wire`)."""

from verticut_tpu_torch.service.server import ImageSearchServer, follow  # noqa: F401
from verticut_tpu_torch.service.client import ImageSearchClient, ReplicatedSearchClient  # noqa: F401
