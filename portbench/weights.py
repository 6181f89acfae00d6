"""The benchmark's weights: drawn on the device from the seed, one call a
leaf, in the layout the port's training step takes (the stacked layers
under ``scan`` carry a leading group axis, as ``repro_torch``'s pytree).

Each leaf has a generator seeded from (seed, leaf index), so that any leaf
can be drawn again alone: the program's side reads its parameters' change
from the weights it started from without holding a second copy, and the
reference draws the same weights after the program has freed its own.
The scales follow the port's initialisers: N(0, 1)·0.02 for the
embedding, N(0, 1)/sqrt(fan-in) for a matrix (fan-in the axis the port's
``dense_init`` takes, the heads for the attention's output), ones for a
norm's scale.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

Path_ = Tuple[str, ...]


def padded_vocab(model: Dict) -> int:
    """The vocabulary rounded up to 512, as the port pads its table and
    head; the padded logits are masked."""
    return (model["vocab"] + 511) // 512 * 512


def _block(kind: str, model: Dict) -> Dict[Path_, Tuple[tuple, float]]:
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv"]
    hd = model.get("head_dim") or d // h
    ones = 0.0      # a norm's scale: filled with ones, not drawn
    out = {("norm1", "scale"): ((d,), ones),
           ("attn", "wq"): ((d, h, hd), d ** -0.5),
           ("attn", "wk"): ((d, kv, hd), d ** -0.5),
           ("attn", "wv"): ((d, kv, hd), d ** -0.5),
           ("attn", "wo"): ((h, hd, d), h ** -0.5),
           ("norm2", "scale"): ((d,), ones)}
    if kind == "attn":
        f = model["d_ff"]
        out.update({("mlp", "wi"): ((d, f), d ** -0.5),
                    ("mlp", "wg"): ((d, f), d ** -0.5),
                    ("mlp", "wo"): ((f, d), f ** -0.5)})
    elif kind == "moe":
        moe = model["moe"]
        e, f = moe["num_experts"], moe["d_expert"] or model["d_ff"]
        out.update({("moe", "router", "w"): ((d, e), d ** -0.5),
                    ("moe", "experts", "wi"): ((e, d, f), d ** -0.5),
                    ("moe", "experts", "wg"): ((e, d, f), d ** -0.5),
                    ("moe", "experts", "wo"): ((e, f, d), f ** -0.5)})
        if moe["num_shared"]:
            fs = f * moe["num_shared"]
            out.update({("moe", "shared", "wi"): ((d, fs), d ** -0.5),
                        ("moe", "shared", "wg"): ((d, fs), d ** -0.5),
                        ("moe", "shared", "wo"): ((fs, d), fs ** -0.5)})
    else:
        raise ValueError(f"no weights for block kind {kind!r}")
    return out


def layout(model: Dict) -> Dict[Path_, Tuple[tuple, float]]:
    """Every leaf's path, shape and scale (0 for a norm's ones), in the
    order the leaves are drawn."""
    d, vp = model["d_model"], padded_vocab(model)
    pattern = model["pattern"]
    groups, tail = divmod(model["n_layers"], len(pattern))
    if tail or model.get("tie_embeddings"):
        raise ValueError("a tail of layers or a tied head is not laid out")
    out = {("embed",): ((vp, d), 0.02), ("final_norm", "scale"): ((d,), 0.0),
           ("lm_head",): ((d, vp), d ** -0.5)}
    for si, kind in enumerate(pattern):
        for path, (shape, std) in _block(kind, model).items():
            out[("scan", f"s{si}_{kind}", *path)] = ((groups, *shape), std)
    return out


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * 7_919 + 1) % (1 << 63)


def draw(model: Dict, seed: int,
         device) -> Iterator[Tuple[Path_, torch.Tensor]]:
    """(path, fp32 leaf) of every leaf in ``layout`` order, each drawn
    with one call from its own generator."""
    gen = torch.Generator(device=device)
    for index, (path, (shape, std)) in enumerate(layout(model).items()):
        if std == 0.0:
            yield path, torch.ones(shape, device=device)
            continue
        gen.manual_seed(_seed(seed, index))
        yield path, torch.randn(shape, generator=gen,
                                device=device).mul_(std)


def nest(flat: Dict[Path_, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, x in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


def make(model: Dict, seed: int, device) -> Dict:
    """The whole tree, every leaf requiring grad."""
    with torch.no_grad():
        flat = {p: x.requires_grad_(True) for p, x in draw(model, seed,
                                                           device)}
    return nest(flat)


def flat(tree: Dict, prefix: Path_ = ()) -> Dict[Path_, torch.Tensor]:
    """The leaves of a nested dict by path, in its order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def change_norms(model: Dict, seed: int, params: Dict,
                 device) -> Dict[str, float]:
    """Each leaf's ‖p − p0‖, p0 drawn again leaf by leaf from the seed."""
    now = flat(params)
    out = {}
    with torch.no_grad():
        for path, p0 in draw(model, seed, device):
            p = now[path]
            p = p.full_tensor() if hasattr(p, "full_tensor") else p
            out["/".join(path)] = float(torch.linalg.vector_norm(
                p.detach().float() - p0))
            del p0
    return out


def total(model: Dict) -> int:
    return sum(math.prod(s) for s, _ in layout(model).values())
