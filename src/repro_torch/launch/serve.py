"""Batched serving (PyTorch), the port of ``repro.launch.serve``:
the prompt is fed token by token through ``serve_step``, then greedy
decode, with a KV cache or recurrent state per layer.

Same arguments and defaults as the JAX version, plus ``--full``,
``--layers`` and ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --batch 2 --prompt-len 8 --gen 8

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA
is asked for and missing. ``run(args)`` returns the per-token step times,
the prompts, the generated ids, the weights, the config and the prompt
batch's frame or patch stubs. A cross-attention arch's encoder states are
computed once from that batch (Whisper's encoder over its frames,
Llama-3.2-Vision's patch embeddings as they are) and fill the decode
state's cross K/V before the first token.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import resolve_device
from repro_torch.models import (init_decode_state, init_params,
                                precompute_cross_kv)
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import _get_encoder_states


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU scale)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = config default)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args) -> dict:
    """Prefill and greedy decode from seeded random weights; returns
    ``prefill_seconds`` and ``decode_seconds`` (one host-clock time per
    token step, each ending in a device synchronise), ``prompts`` (B,
    prompt_len) on the device, ``ids`` (B, gen) on the CPU, ``params``,
    ``config`` and ``stubs``: the prompt batch's ``frames`` or
    ``enc_embed`` on the device (an empty dict for a decoder-only arch),
    so that ``forward`` can run again on what was served."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    params = init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    data = SyntheticLM(cfg, args.batch, args.prompt_len, seed=args.seed)
    batch = data.next_batch()
    prompts = batch["tokens"].to(device)
    stubs = {k: v.to(device) for k, v in batch.items()
             if k not in ("tokens", "labels")}
    state = init_decode_state(cfg, args.batch, args.prompt_len + args.gen,
                              device)
    if cfg.cross_len:
        with torch.no_grad():
            enc = _get_encoder_states(params, stubs, cfg)
            state = precompute_cross_kv(params, state,
                                        enc.to(dtype_of(cfg.dtype)), cfg)
        del enc
    step = make_serve_step(cfg)

    def timed(token):
        nonlocal state
        t0 = time.perf_counter()
        logits, state = step(params, state, token)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return logits, time.perf_counter() - t0

    # prefill: feed prompt tokens through the decode path
    prefill_seconds, decode_seconds, out = [], [], []
    logits = None
    for i in range(args.prompt_len):
        logits, dt = timed(prompts[:, i])
        prefill_seconds.append(dt)

    # greedy decode
    tok = logits.argmax(-1)
    for _ in range(args.gen):
        out.append(tok)
        logits, dt = timed(tok)
        decode_seconds.append(dt)
        tok = logits.argmax(-1)

    ids = torch.stack(out, dim=1).cpu()
    t_prefill, t_gen = sum(prefill_seconds), sum(decode_seconds)
    print(f"arch={cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill:.2f}s, "
          f"decode {args.gen} tok in {t_gen:.2f}s "
          f"({args.batch * args.gen / max(t_gen, 1e-9):,.1f} tok/s)")
    print("first generated ids:", ids[0, :12].tolist())
    return {"prefill_seconds": prefill_seconds,
            "decode_seconds": decode_seconds, "prompts": prompts, "ids": ids,
            "params": params, "config": cfg, "stubs": stubs}


def main() -> None:
    run(build_argparser().parse_args())


if __name__ == "__main__":
    main()
