"""Training driver: port of ``repro/launch/train.py``, with the same
flags, defaults and printed lines, plus ``--device`` (default ``cuda``;
the CPU only when asked for).

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

The loop wires the port's pieces together: the synthetic data pipeline
(``repro_torch.data``), the microbatched AdamW step
(``train.make_train_step``), async checkpointing with restart-on-launch
(``repro_torch.checkpoint``, the reference's disk format: either
package resumes the other's run) and, with ``--compress``, int8
gradient compression.  The weights are the reference's for the same
``--seed`` (``init_params``, bit for bit), so both drivers print the
same losses up to rounding.  ``--mesh production``/``multipod`` place
the state on a TPU mesh; one GPU has none (ROADMAP A11.7), so they are
refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM, host_slice, prefetch
from repro_torch.device import resolve_device
from repro_torch.train import (OptimizerConfig, init_train_state,
                               make_train_step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", choices=("host", "production", "multipod"),
                    default="host")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression + error feedback")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh != "host":
        raise SystemExit(f"--mesh {args.mesh} is not ported to repro_torch "
                         f"(one GPU; mesh code is ROADMAP A11.7)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)

    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 20,
                              total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, compress=args.compress,
                              accum_steps=args.accum, device=device)

    state = init_train_state(args.seed, cfg, compress=args.compress,
                             device=device)
    start_step = 0
    saver = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        saver = AsyncCheckpointer(ckpt)
        got = ckpt.restore_latest(state, device)
        if got is not None:
            start_step, state, _ = got
            print(f"restored checkpoint at step {start_step}")

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    def batches():
        s = start_step
        while True:
            yield s, data.batch(s)
            s += 1

    t0 = time.time()
    tokens = 0
    for s, host_batch in prefetch(iter(batches()), depth=2):
        if s >= args.steps:
            break
        batch = dict(host_slice(host_batch))
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (args.batch, args.seq, cfg.d_model), dtype=torch.bfloat16)
        state, metrics = step_fn(state, batch)
        tokens += args.batch * args.seq
        if (s + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {s + 1:5d} loss {loss:7.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"tok/s {tokens / dt:9.0f}")
        if saver is not None and (s + 1) % args.ckpt_every == 0:
            saver.save(s + 1, state, extra={"tokens": tokens})
    if saver is not None:
        saver.save(args.steps, state, extra={"tokens": tokens})
        saver.wait()
    print("done.")


if __name__ == "__main__":
    main()
