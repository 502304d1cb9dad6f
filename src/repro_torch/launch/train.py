"""Training launcher, the port of ``repro.launch.train``.

On the CUDA card (the default device), full width, depth cut to 4 layers:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --layers 4 --steps 20 --scheme diagonal --pods 2 --seq 512

On the CPU, the reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --device cpu --steps 4 --scheme sync

``--scheme sync`` is the fully synchronous baseline; the consensus schemes
combine the pods' estimates every ``--h-steps`` local steps
(:mod:`repro_torch.train.consensus`). It prints the reference's step and
round lines.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs as CFG
from ..checkpoint import io as CK
from ..data.pipeline import DataConfig, SyntheticLM, pod_sharded_batches
from ..device import resolve_device
from ..optim import adamw
from ..train import consensus as CT
from ..train import step as TS


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scheme", default="sync",
                    choices=["sync", "uniform", "diagonal", "max", "admm"])
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--h-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG.get(args.arch)
    if args.reduced:
        cfg = CFG.reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ocfg = adamw.AdamWConfig(lr=args.lr,
                             warmup_steps=max(args.steps // 10, 1),
                             total_steps=max(args.steps, 2))
    tcfg = TS.TrainConfig()
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                global_batch=args.batch), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    if args.scheme == "sync":
        state = TS.init_state(cfg, gen, device)
        step_fn = TS.make_train_step(cfg, ocfg, tcfg)
        for i, batch in zip(range(args.steps), ds):
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            nll = float(metrics["nll"])    # waits for the step's kernels
            print(f"step {i:4d} nll={nll:.4f} ({time.time()-t0:.2f}s)",
                  flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                CK.save(args.ckpt_dir, i + 1, state,
                        extra={"arch": cfg.arch_id})
    else:
        ccfg = CT.ConsensusConfig(n_pods=args.pods, scheme=args.scheme,
                                  h_steps=args.h_steps)
        state = CT.init_state(cfg, gen, ccfg, device)
        round_fn = CT.make_round_step(cfg, ocfg, tcfg, ccfg)
        batches = pod_sharded_batches(ds, args.pods, args.h_steps)
        n_rounds = args.steps // args.h_steps
        for r, batch in zip(range(n_rounds), batches):
            t0 = time.time()
            state, metrics = round_fn(state, batch)
            nll = float(metrics["nll"])
            print(f"round {r:4d} ({args.h_steps} local steps/pod) "
                  f"nll={nll:.4f} ({time.time()-t0:.2f}s)", flush=True)
            if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
                # Thm 3.1's any-time property: theta_bar is always a valid
                # checkpoint, even mid-ADMM
                CK.save(args.ckpt_dir, r + 1, state.theta_bar,
                        extra={"arch": cfg.arch_id, "scheme": args.scheme})
    print("done")


if __name__ == "__main__":
    main()
