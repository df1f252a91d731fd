"""Twin-driven serving admission: the paper's feedback loop at request
granularity.

The ServingEngine's admission hook is wired to a miniature what-if
evaluation: before refilling a free slot, the queue of pending requests
is scored under SJF-like and FCFS-like admission orders using the
twin's predictive machinery (estimated decode lengths stand in for
walltime estimates), and the better order picks the next request.

    python -m repro_torch.examples.serve_twin [--device cpu]

The report depends on no weight: a request ends at its
``max_new_tokens`` (no EOS), so it prints the same lines as the JAX
package's ``examples/serve_twin.py`` on any device, though its model's
head dim is 32 (K4's least) where the reference's smoke config has 16.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine

N = 12


def requests_cost(req: Request) -> float:
    return len(req.prompt) + req.max_new_tokens   # estimated service time


def twin_admission(decisions: Dict[str, int]):
    """Pick FCFS head unless a much shorter job exists (what-if: the
    shorter job finishes before the head would — the same EASY-style
    reasoning the cluster twin applies, at request scale)."""
    def admit(queue: List[Request]) -> int:
        head_cost = requests_cost(queue[0])
        best = min(range(len(queue)), key=lambda i: requests_cost(queue[i]))
        if requests_cost(queue[best]) * 2 < head_cost:
            decisions["SJF"] += 1
            return best
        decisions["FCFS"] += 1
        return 0
    return admit


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # head dim 32, the least K4 takes (the smoke config's is 16, which
    # the card's prefill would refuse); the report depends on no weight
    cfg = get_smoke_config("llama3.2-1b", head_dim=32)
    model = api.init_model(cfg, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    requests = []
    for r in range(N):
        plen = int(rng.integers(2, 10))
        new = int(rng.integers(2, 12))
        requests.append(Request(req_id=r,
                                prompt=rng.integers(0, cfg.vocab_size,
                                                    plen).astype(np.int32),
                                max_new_tokens=new))

    decisions = {"SJF": 0, "FCFS": 0}
    engine = ServingEngine(cfg, model, batch_slots=3, max_seq=32,
                           admission=twin_admission(decisions),
                           device=args.device)
    for r in requests:
        engine.submit(r)
    engine.run_until_drained()

    waits = [r.first_token_t - r.arrival_t for r in requests]
    print(f"served {N} requests with twin-driven admission")
    print(f"admission decisions: {decisions}")
    print(f"mean queue wait {np.mean(waits):.1f} steps, "
          f"max {np.max(waits):.1f}")
    print("every request completed:",
          all(r.done for r in requests))


if __name__ == "__main__":
    main()
