#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py

Run from the repo root, with nothing but the checkout: it builds every
kernel from ``src/repro_torch/kernels/csrc/`` into ``build/``, then

  1. holds each kernel against its plain PyTorch version on the card over
     the reference test matrix and at the shapes of the main path;
  2. checks the model on the card against itself with the kernel off
     (gemma-7b smoke config with head_dim 64, fp32, S = 256: loss and
     gradients);
  3. drives the main path through ``repro_torch.launch.train.run``:
     gemma-7b at full width with 4 of its 28 layers, B = 2, S = 2048,
     5 AdamW steps, bf16, remat, flash kernel on; with the launch counts
     set to 0 just before and read just after;
  4. times each kernel, its plain version and the nearest PyTorch library
     call at the main path's shape, beside the card's bound;
  5. profiles one more training step (device time by kernel, idle share).

Each result is printed as it comes; the line before the card's name is one
JSON object with the kernels, and the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
It exits non-zero at once when CUDA is not available.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks of one H100 SXM (NVIDIA data sheet).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# The main path: gemma-7b at full width, 4 of its 28 layers.
MAIN_ARGV = ["--arch", "gemma-7b", "--full", "--layers", "4", "--batch", "2",
             "--seq", "2048", "--steps", "5", "--device", "cuda",
             "--log-every", "1"]
SLICE = (2, 2048, 16, 16, 256)          # b, s, h, kv, d at the main path
# Profile groups, by kernel name (first match wins).
KERNEL_GROUPS = [
    ("flash_attention", ("attn_fwd",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax/reduce", ("softmax", "reduce", "logsumexp")),
    ("copy/cast", ("copy",)),
    ("elementwise", ("elementwise",)),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention visits for these shapes."""
    if not causal:
        return s * t
    total = 0
    for i in range(s):
        qa = i + t - s
        lo = max(0, qa - window + 1) if window > 0 else 0
        total += max(0, min(t, qa + 1) - lo)
    return total


def attention_bound(b, s, h, kv, d, t, dtype: str, causal=True, window=0):
    """(bound_ms, bound_by): the larger of FLOPs over peak and bytes over
    memory rate; q, k, v read once and o written once."""
    flops = 4 * b * h * d * attention_pairs(s, t, causal, window)
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * d * (2 * b * s * h + 2 * b * t * kv)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import build, flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- build --------------------------------------------------------------
    t0 = time.time()
    lib, log = build()
    print(f"build: {lib.name} in {time.time() - t0:.1f} s")
    name = None
    for line in log.splitlines():   # one line per kernel instantiation
        m = re.search(r"attn_fwdILi(\d+)E(f|13__nv_bfloat16)Lb([01])E", line)
        if m:
            name = (f"attn_fwd<D={m[1]}, {'fp32' if m[2] == 'f' else 'bf16'},"
                    f" causal={m[3]}>")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas: {name}: {m[1]} registers")
        if "spill" in line and not line.strip().startswith("0 bytes stack"):
            print(f"  ptxas: {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(b, s, h, kv, d, dtype, t=None):
        t = t or s
        return [torch.randn(shape, device="cuda", generator=gen)
                .to(dtypes[dtype]) for shape in
                ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]

    # -- phase 1: kernel against its plain version --------------------------
    cases = [(shape, dt, True, 0, None)
             for shape in [(1, 128, 1, 1, 64), (2, 256, 4, 2, 64),
                           (1, 512, 8, 8, 128), (2, 384, 6, 2, 64),
                           (1, 256, 4, 1, 128)]
             for dt in ("float32", "bfloat16")]
    cases += [((1, 512, 4, 2, 64), "float32", True, w, None)
              for w in (64, 128, 256)]
    cases += [((2, 256, 4, 4, 64), "float32", False, 0, None),
              ((1, 256, 4, 2, 64), "float32", True, 0, 512),     # T > S
              ((1, 256, 4, 2, 64), "float32", True, 128, 512),
              ((1, 256, 2, 2, 256), "float32", True, 0, None),
              (SLICE, "bfloat16", True, 0, None)]
    slice_err = None
    for shape, dt, causal, window, t in cases:
        q, k, v = inputs(*shape, dt, t=t)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= TOL[dt] * (1 + want.float().abs())).all())
        print(f"kernel-vs-plain {shape} t={t or shape[1]} {dt} "
              f"causal={causal} window={window}: max_abs_err {err:.3e} "
              f"(tol {TOL[dt]}) {'ok' if ok else 'FAIL'}", flush=True)
        require(ok and math.isfinite(err), f"kernel disagrees at {shape} {dt}")
        if (shape, dt) == (SLICE, "bfloat16"):
            slice_err = err
        del q, k, v, out, want, diff

    # the autograd op on CUDA tensors: kernel forward, reference backward
    q, k, v = (x.requires_grad_() for x in inputs(1, 256, 2, 2, 64,
                                                 "float32"))
    before = flash_attention_fwd.launches
    (ops.flash_attention(q, k, v, True, 0) ** 2).sum().backward()
    require(flash_attention_fwd.launches == before + 1,
            "ops.flash_attention did not launch the kernel")
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (flash_attention_ref(q, k, v, True, 0) ** 2).sum().backward()
    gerr = max((a - x.grad).abs().max().item() for a, x in zip(grads, (q, k, v)))
    print(f"op gradients vs plain autograd: max_abs_err {gerr:.3e} (tol 1e-4)")
    require(gerr <= 1e-4, "op gradients disagree")

    # -- phase 2: the model on the card, kernel on vs off -------------------
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    # head_dim 64: the kernel is built for head widths 64, 128 and 256
    cfg = get_config("gemma-7b", smoke=True).replace(
        head_dim=64, use_flash_kernel=True, remat=True)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 257), device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    res = {}
    for flag in (True, False):
        c = cfg.replace(use_flash_kernel=flag)
        loss, _ = transformer.loss_fn(params, batch, c)
        res[flag] = (loss.item(), torch.autograd.grad(loss,
                                                      list(leaves(params))))
    lerr = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    gerr = max((a - b).abs().max().item()
               for a, b in zip(res[True][1], res[False][1]))
    print(f"model (gemma-7b smoke, head_dim 64, fp32, S=256) flash vs naive: loss "
          f"{res[True][0]:.6f} vs {res[False][0]:.6f} (rel {lerr:.2e}, "
          f"tol 1e-5), grads max_abs_err {gerr:.2e} (tol 1e-4)")
    require(lerr <= 1e-5 and gerr <= 1e-4, "model flash path disagrees")
    del params, res, batch

    # -- phase 3: the main path --------------------------------------------
    from repro_torch.launch import train
    args = train.build_argparser().parse_args(MAIN_ARGV)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    result = train.run(args, use_flash_kernel=True)
    launches = flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    mcfg = result["config"]
    per_step = mcfg.n_layers * (2 if mcfg.remat else 1)
    step_ms = [1e3 * s for s in result["step_seconds"]]
    steady = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    tokens = args.batch * args.seq
    print(f"main path: {mcfg.name} d_model {mcfg.d_model} heads "
          f"{mcfg.n_heads}x{mcfg.head_dim} kv {mcfg.n_kv} d_ff {mcfg.d_ff} "
          f"vocab {mcfg.vocab} layers {mcfg.n_layers} dtype {mcfg.dtype} "
          f"remat {mcfg.remat} flash {mcfg.use_flash_kernel}")
    print("main path losses: " + " ".join(f"{x:.4f}" for x in result["losses"]))
    print("main path ms/step: " + " ".join(f"{x:.1f}" for x in step_ms)
          + f" (median after the first {steady:.1f})")
    # model FLOPs of a step: 6 N T for the parameter matmuls (N includes the
    # tied head) plus forward + backward attention; remat recompute excluded
    n_params = result["param_count"]
    attn = 3 * mcfg.n_layers * 4 * args.batch * mcfg.n_heads \
        * mcfg.head_dim * attention_pairs(args.seq, args.seq, True, 0)
    flops = 6 * n_params * tokens + attn
    print(f"main path params {n_params} model FLOPs/step {flops:.4e} "
          f"achieved {flops / steady / 1e9:.1f} TFLOP/s "
          f"({flops / steady / 1e9 / (PEAK_FLOPS['bfloat16'] / 1e12):.3f}"
          f" of the bf16 peak)")
    print(f"main path tokens/s: {tokens / steady * 1e3:.1f}  peak memory "
          f"{peak / 2**30:.2f} GiB  flash launches {launches} "
          f"(expected {per_step} x {args.steps})", flush=True)
    require(all(math.isfinite(x) for x in result["losses"]),
            "non-finite loss on the main path")
    require(launches == per_step * args.steps,
            f"flash kernel launched {launches} times, expected "
            f"{per_step * args.steps}")
    del result

    # -- phase 4: timings at the main path's attention shape ----------------
    import torch.nn.functional as F
    b, s, h, kv, d = SLICE
    q, k, v = inputs(b, s, h, kv, d, "bfloat16")
    saved = flash_attention_fwd.launches
    k_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=20)
    p_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=20)
    flash_attention_fwd.launches = saved
    bound, bound_by = attention_bound(b, s, h, kv, d, s, "bfloat16")
    print(f"flash_attention at {SLICE} bf16 causal: kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms, sdpa {l_ms:.3f} ms, bound {bound:.4f} ms "
          f"({bound_by})", flush=True)
    del q, k, v, qt, kt, vt

    # -- phase 5: device time of one training step, by kernel ---------------
    profile_step(args)

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": l_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_step(args) -> None:
    """Device time of one steady training step of the main path, by kernel,
    and the share of the step's host wall time the device was idle (the
    profiler's own host cost makes that share an upper bound)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer

    cfg = get_config(args.arch, smoke=args.smoke).replace(
        n_layers=args.layers, use_flash_kernel=True)
    opt = make_optimizer(args.optimizer or "adamw", lr=args.lr)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    params = init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    def step():
        nonlocal params, state
        batch = {k: x.cuda() for k, x in data.next_batch().items()}
        params, state, metrics = step_fn(params, state, batch)
        return float(metrics["loss"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    if busy <= 0:
        print("profile of one step: no device time in the trace "
              "(not measured)")
        return
    print(f"profile of one step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    groups = {}
    for name, ms, _ in rows:
        cat = next((c for c, keys in KERNEL_GROUPS if any(
            key in name for key in keys)), "other")
        groups[cat] = groups.get(cat, 0.0) + ms
    print("profile by group: " + ", ".join(
        f"{c} {ms:.1f} ms ({ms / busy:.3f})"
        for c, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, ms, n in rows[:15]:
        print(f"  {ms:9.2f} ms {n:5d}x  {name[:110]}")


if __name__ == "__main__":
    try:
        code = main()
    except Exception:   # report any phase's failure and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
