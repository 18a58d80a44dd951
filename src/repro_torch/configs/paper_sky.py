"""The paper's own workload: the supernovae "sky view" blob (§V).

1 TB global string, 64 KB pages, segments of 16 KB - 16 MB accessed by
concurrent clients. Benchmarks (Fig. 3 reproductions) read these constants.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    blob_size: int = 1 << 40  # 1 TB logical
    page_size: int = 64 << 10  # 64 KB
    segment_min: int = 16 << 10
    segment_max: int = 16 << 20
    hot_interval: int = 1 << 30  # clients touch a 1 GB working window
    n_data_providers: int = 20
    n_metadata_providers: int = 20
    # Grid'5000 Rennes cluster model (paper §V.B)
    latency_s: float = 0.1e-3
    bandwidth_Bps: float = 117.5e6


CONFIG = SkyConfig()
