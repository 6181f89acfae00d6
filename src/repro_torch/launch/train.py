"""End-to-end training entry point (PyTorch), the port of
``repro.launch.train``.

Same arguments and defaults as the JAX version, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --smoke --steps 20 --batch 8 --seq 128 --device cpu

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA
is asked for and missing. ``run(args, **cfg_overrides)`` applies config
overrides on top of the command line, e.g. ``use_flash_kernel=True``.

Fault tolerance and the paper's training mode, as in the reference:
  * checkpoints (params + optimizer + data-pipeline state) every
    --ckpt-every steps and at the last step, in the reference's layout;
    a run with --ckpt-dir resumes from LATEST;
  * --fail-at N raises a simulated hard fault at step N;
  * --async-staleness applies tau-stale gradients (``optim.async_sgd``);
  * --compress {int8,topk} runs gradient compression with error feedback.

In async mode the reference saves ``opt_state``, which that mode never
updates, and a resumed async run starts from a fresh ``async_init`` (zero
moments, an empty gradient ring): it does not continue the run it
restarts. The port keeps that behaviour, as it keeps every other.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_optimizer_name
from repro_torch.data import SyntheticLM
from repro_torch.device import require_device
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.models import init_params, param_count
from repro_torch.optim import (async_init, async_step, make_compressor,
                               make_optimizer)


def resolve_device(device: str) -> torch.device:
    """``device`` as asked; a missing card is an error, never a silent move
    to the CPU."""
    dev = require_device(device)
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a hard fault at this step (testing)")
    ap.add_argument("--async-staleness", type=int, default=0,
                    help="PS-style async SGD with this staleness")
    ap.add_argument("--compress", choices=["", "int8", "topk"], default="")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, **cfg_overrides) -> dict:
    """Train; returns losses and timings, the final ``params`` and
    ``opt_state``, and the seconds of each checkpoint save
    (``ckpt_seconds``) and of the restore (``restore_seconds``, None when
    the run did not resume). ``cfg_overrides`` replace config fields after
    the command-line ones."""
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

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen, cfg)
    opt_state = opt.init(params)
    start_step = 0
    restore_seconds = None

    # resume: into the tensors just made, in place
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        t0 = synced()
        tree, meta = ckpt.restore(args.ckpt_dir,
                                  {"params": params, "opt_state": opt_state})
        restore_seconds = synced() - t0
        params, opt_state = tree["params"], tree["opt_state"]
        data.load_state_dict(meta["data_state"])
        start_step = int(meta["step"]) + 1
        print(f"resumed from step {start_step - 1}")

    use_async = args.async_staleness > 0
    compressor = make_compressor(args.compress) if args.compress else None
    comp_err = compressor.init(params) if compressor else None

    if use_async or compressor:
        grad_fn = make_grad_step(cfg)
        if use_async:
            astate = async_init(params, opt, args.async_staleness)
    else:
        step_fn = make_train_step(cfg, opt)

    losses, step_seconds, ckpt_seconds = [], [], []
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    for step in range(start_step, args.steps):
        if step == args.fail_at:
            raise RuntimeError(f"simulated node failure at step {step}")
        ts = time.time()
        batch = {k: v.to(device) for k, v in data.next_batch().items()}
        if use_async or compressor:
            grads, metrics = grad_fn(params, batch)
            if compressor:
                payload, comp_err = compressor.compress(grads, comp_err)
                grads = compressor.decompress(payload)
                del payload
            if use_async:
                astate = async_step(astate, grads, opt, args.async_staleness)
                params = astate.params
            else:
                params, opt_state = opt.update(grads, opt_state, params)
            del grads
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        step_seconds.append(time.time() - ts)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tps = tokens_per_step * (step - start_step + 1) / max(dt, 1e-9)
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"({tps:,.0f} tok/s)", flush=True)
        if args.ckpt_dir and (step % args.ckpt_every == 0
                              or step == args.steps - 1):
            ts = synced()
            ckpt.save(args.ckpt_dir, step,
                      {"params": params, "opt_state": opt_state},
                      metadata={"step": step,
                                "data_state": data.state_dict(),
                                "arch": args.arch})
            ckpt.cleanup(args.ckpt_dir, keep=3)
            ckpt_seconds.append(time.perf_counter() - ts)

    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "losses": losses,
              "step_seconds": step_seconds, "config": cfg,
              "param_count": param_count(params),
              "ckpt_seconds": ckpt_seconds,
              "restore_seconds": restore_seconds,
              "params": params, "opt_state": opt_state}
    if losses:
        print(f"done: loss {result['first_loss']:.4f} -> "
              f"{result['last_loss']:.4f} over {result['steps']} steps")
    return result


def main() -> None:
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
