"""Serving driver: continuous batching over synthetic requests.

Port of ``repro/launch/serve.py``, with the same flags and printed lines,
plus ``--device`` (default ``cuda``; the CPU only when asked for) and
``--backend`` (default ``cuda``: the hand-written kernels on CUDA
tensors; ``reference`` runs their plain versions, for checks).  Weights
are random, drawn from ``--seed`` on the device: the JAX package's
weights for the same seed, bit for bit (``models.common.init_params``).  Every ``--arch`` serves but internvl2-76b:
the engine feeds a vlm no patch embeddings, and the reference's fails on
it (ROADMAP C15).

    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
        --requests 16 --slots 4 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", choices=("host", "production"), default="host")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=api.BACKENDS, default="cuda")
    return ap


def make_requests(cfg, n: int, max_seq: int, max_new: int,
                  seed: int) -> List[Request]:
    """The reference driver's synthetic requests: prompt lengths uniform
    in [4, max_seq // 2), tokens uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        plen = int(rng.integers(4, max_seq // 2))
        reqs.append(Request(
            req_id=r,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=max_new))
    return reqs


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh == "production":
        raise SystemExit("--mesh production is not ported to repro_torch "
                         "(one GPU; mesh code is ROADMAP A11.7)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm":
        raise SystemExit(f"{args.arch}: the serving engine feeds a vlm no "
                         f"patch embeddings (ROADMAP C15)")
    device = resolve_device(args.device)
    model = api.init_model(cfg, seed=args.seed, device=device)
    reqs = make_requests(cfg, args.requests, args.max_seq, args.max_new,
                         args.seed)

    eng = ServingEngine(cfg, model, batch_slots=args.slots,
                        max_seq=args.max_seq, device=device,
                        backend=args.backend)
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    toks = sum(len(r.output) for r in reqs)
    ttfts = [r.first_token_t - r.arrival_t for r in reqs
             if r.first_token_t is not None]
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    print(f"mean TTFT {np.mean(ttfts):.1f} engine-steps, "
          f"mean tokens/req {toks / len(reqs):.1f}")


if __name__ == "__main__":
    main()
