"""The plain reference: a decoder LM (``model.py``) and AdamW in plain
PyTorch, driven through the steps the check compares (``follow``). It
imports nothing of the port, only the benchmark's own weights."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench import weights
from portbench.reference.model import Precision, loss_and_grads


@torch.no_grad()
def adamw(params: Dict, moments: Dict, step: int, hp: Dict) -> None:
    """AdamW in fp32, in place: m, v the moments, bias-corrected, and
    decoupled weight decay on every leaf."""
    b1, b2 = hp["b1"], hp["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for path, p in params.items():
        g = p.grad
        m, v = moments.setdefault(path, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / bc1) / ((v / bc2).sqrt() + hp["eps"])
        upd.add_(p, alpha=hp["weight_decay"])
        p.sub_(upd, alpha=hp["lr"])


def follow(model: Dict, seed: int, batches: List, hp: Dict, device,
           prec: Precision = Precision(), rows: int = 1,
           keep_rows: Optional[int] = None) -> Dict:
    """The reference's first ``len(batches)`` steps from the benchmark's
    weights of ``seed``: each step's loss, each leaf's first-gradient
    norm, and each leaf's change after the last step (the weights drawn
    again leaf by leaf). ``keep_rows`` keeps that many rows of each batch
    (a fault: the rest of the batch left out)."""
    tree = weights.make(model, seed, device)
    params = weights.flat(tree)
    moments: Dict = {}
    losses, grad_norms = [], {}
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for step, (tokens, labels) in enumerate(batches, start=1):
            if keep_rows is not None:
                tokens, labels = tokens[:keep_rows], labels[:keep_rows]
            for p in params.values():
                p.grad = None
            losses.append(loss_and_grads(tree, tokens.to(device),
                                         labels.to(device), model, prec,
                                         rows))
            if step == 1:
                grad_norms = {"/".join(k): float(p.grad.norm())
                              for k, p in params.items()}
            adamw(params, moments, step, hp)
        for p in params.values():
            p.grad = None
        del moments
        change = weights.change_norms(model, seed, tree, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
    del tree, params
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
