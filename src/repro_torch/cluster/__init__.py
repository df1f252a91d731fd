"""Physical-system side: PBS-like cluster emulator and workloads."""
from repro_torch.cluster.emulator import ClusterEmulator, FailureSpec, RunReport
from repro_torch.cluster.workload import (JobSpec, Phase, bursty_trace,
                                          paper_synthetic_trace,
                                          poisson_trace)

__all__ = [
    "JobSpec", "Phase", "paper_synthetic_trace", "poisson_trace",
    "bursty_trace", "ClusterEmulator", "FailureSpec", "RunReport",
]
