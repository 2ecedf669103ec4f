"""``repro_torch.serve`` — the serving layer: a batched ProHD service
(pairwise distances and corpus search) and the async admission-batching
query engine over its corpus."""
from repro_torch.serve.engine import EngineConfig, QueryEngine
from repro_torch.serve.server import ProHDService, ServeConfig

__all__ = ["ServeConfig", "ProHDService", "EngineConfig", "QueryEngine"]
