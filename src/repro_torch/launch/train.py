"""End-to-end training entry point (PyTorch), the port of
``repro.launch.train``.

Same arguments and defaults as the JAX version, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --smoke --steps 20 --batch 8 --seq 128 --device cpu

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA
is asked for and missing. ``run(args, **cfg_overrides)`` applies config
overrides on top of the command line, e.g. ``use_flash_kernel=True``.
Checkpoints, ``--fail-at``, async SGD and compression are not ported yet
(ROADMAP 1.5 and 1.12).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_optimizer_name
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, param_count
from repro_torch.optim import make_optimizer


def resolve_device(device: str) -> torch.device:
    """``device`` as asked; a missing card is an error, never a silent move
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but CUDA is not available; "
            "pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU scale)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = config default)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, **cfg_overrides) -> dict:
    """Train; returns losses and timings. ``cfg_overrides`` replace config
    fields after the command-line ones."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
    overrides.update(cfg_overrides)
    if overrides:
        cfg = cfg.replace(**overrides)
    opt_name = args.optimizer or get_optimizer_name(args.arch)
    if opt_name == "adafactor" and args.smoke:
        opt_name = "adamw"
    opt = make_optimizer(opt_name, lr=args.lr)

    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen, cfg)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    losses, step_seconds = [], []
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    for step in range(args.steps):
        ts = time.time()
        batch = {k: v.to(device) for k, v in data.next_batch().items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        step_seconds.append(time.time() - ts)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tps = tokens_per_step * (step + 1) / max(dt, 1e-9)
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"({tps:,.0f} tok/s)", flush=True)

    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "losses": losses,
              "step_seconds": step_seconds, "config": cfg,
              "param_count": param_count(params)}
    if losses:
        print(f"done: loss {result['first_loss']:.4f} -> "
              f"{result['last_loss']:.4f} over {result['steps']} steps")
    return result


def main() -> None:
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
