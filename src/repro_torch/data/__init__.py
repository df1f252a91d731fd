"""Data substrate: the deterministic synthetic pipeline and the
host-ingest prefetcher of the block-streamed grids."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, host_slice,
                                       prefetch)

__all__ = ["DataConfig", "SyntheticLM", "host_slice", "prefetch"]
