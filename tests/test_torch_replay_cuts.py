"""Where the port runs cross-attention's k and v and a MoE block's output
products, on 16 x 16 (256 fake ranks, the CPU route), against the
reference's counts.

* Cuts: llama-3.2-vision-90b at 5 layers (one group: four self-attention
  layers and one gated cross-attention layer) ``prefill_32k`` and
  ``train_4k``, arctic-480b at 2 layers ``train_4k``. FLOPs a device equal
  to the reference's (``CUTS``), in training plus the flash VJP's
  recomputed logits, u = 2·B·S²·D·H/256 a self-attention layer (the
  reference's dry-run runs plain attention; apart by design).
* Named products: llama's cross k and v, in ``prefill_32k`` the rank's d
  slice of the patch embeddings by the weight's rows (XLA's ``dot.183`` /
  ``dot.184``, ``f32[3202,512]`` by ``f32[512,1024]``); in ``train_4k`` the
  forward and its remat replay whole and each weight gradient on 1/16 of
  the weight. arctic's remat replay runs none of the block's output
  products (the combine and the dense FFN's ``wo``).
"""
import collections

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, get_optimizer_name
from repro_torch.core import flop_count
from repro_torch.launch import dryrun
from repro_torch.models import moe

LLAMA, ARCTIC = "llama-3.2-vision-90b", "arctic-480b"
TP = 16                      # ``model`` on the production mesh
# (arch, shape, layers): the reference's FLOPs a device on 16 x 16
# (``test_torch_moe_shards.reference_counts([f"{arch}:{shape}"],
# n_layers=layers)``)
CUTS = {(LLAMA, "prefill_32k", 5): 69593909428224,
        (LLAMA, "train_4k", 5): 199754130653184,
        (ARCTIC, "train_4k", 2): 46119358824448}


@pytest.fixture(scope="module")
def cuts():
    """Each cut's config, FLOPs a device and every matrix product:
    (operand shapes, FLOPs, whether it ran in the backward)."""
    out, count = {}, flop_count.DeviceCounter._count
    for arch, shape, layers in CUTS:
        products = []

        def spy(self, func, args, kwargs, res):
            before = self.counts.flops
            count(self, func, args, kwargs, res)
            if self.counts.flops > before:
                products.append((
                    tuple(tuple(a.shape) for a in args[:2]),
                    self.counts.flops - before,
                    torch._C._current_graph_task_id() != -1))

        flop_count.DeviceCounter._count = spy
        try:
            cfg = get_config(arch).replace(n_layers=layers,
                                           use_flash_kernel=True)
            with dryrun.fake_process_group(256):
                mesh = dryrun.make_production_mesh(device_type="cpu")
                counts = dryrun.trace_step(cfg, SHAPES[shape], mesh,
                                           get_optimizer_name(arch))["counts"]
        finally:
            flop_count.DeviceCounter._count = count
        out[arch, shape] = (cfg, counts.flops, products)
    return out


def _flash_u(cfg, shape: str) -> int:
    """The flash VJP's recomputed logits product a device and layer."""
    sp = SHAPES[shape]
    return (2 * sp.global_batch * sp.seq_len ** 2 * cfg.head_dim
            * cfg.n_heads // 256)


@pytest.mark.parametrize("cut", sorted(CUTS),
                         ids=lambda c: "{}-{}-{}".format(*c))
def test_cut_flops_are_the_references(cut, cuts):
    """The reference's FLOPs a device exactly, plus u a self-attention
    layer in training (before: llama's cross k and v products whole on
    every ``model`` rank, 15/16 of a pass of them too many in prefill and
    of their weight gradients in training; arctic's remat replaying its
    combine, 1.50e11 a layer)."""
    arch, shape, layers = cut
    cfg, flops, _ = cuts[arch, shape]
    attn = sum(k != "xattn" for k in cfg.pattern) * layers // len(
        cfg.pattern)
    named = attn * _flash_u(cfg, shape) if shape == "train_4k" else 0
    want = CUTS[cut]
    print(f"\n{arch} {shape}, {layers} layers: FLOPs a device {flops} = "
          f"reference {want} + {named} ({flops / want:.6f}x)")
    assert flops == want + named


def _cross_kv(cfg, shape: str):
    """(rows, d, kv·D) of llama's cross k and v products a device: the
    patch embeddings' rows on the rank (its batch rows by 1601 patches)."""
    rows = SHAPES[shape].global_batch // TP * cfg.cross_len
    return rows, cfg.d_model, cfg.n_kv * cfg.head_dim


def test_prefill_cross_kv_split_their_contraction(cuts):
    """``prefill_32k``: each cross k and v product is the rank's d slice of
    the embeddings by the weight's matching rows (3202 x 512 by 512 x
    1024), as XLA's ``dot.183`` / ``dot.184``, and no product takes the
    whole contraction of d over the source's rows."""
    cfg, _, products = cuts[LLAMA, "prefill_32k"]
    rows, d, n = _cross_kv(cfg, "prefill_32k")
    got = collections.Counter(shapes for shapes, _, _ in products
                              if shapes[0][-2] == rows)
    assert got == {((1, rows, d // TP), (1, d // TP, n)): 2}


def test_train_cross_kv_weight_gradients_run_on_a_sixteenth(cuts):
    """``train_4k``: the cross k and v products run whole in the forward
    and in the remat replay (XLA's ``dot.482`` / ``.483`` and ``dot.613``
    / ``.614``), and each weight gradient, the product that contracts the
    rank's source rows, on 1/16 of the weight: 2·rows·d·(kv·D)/16 FLOPs
    (before: whole)."""
    cfg, _, products = cuts[LLAMA, "train_4k"]
    rows, d, n = _cross_kv(cfg, "train_4k")
    whole = collections.Counter(back for shapes, _, back in products
                                if shapes == ((1, rows, d), (1, d, n)))
    assert whole == {False: 2, True: 2}
    grads = [(a, b, f) for (a, b), f, _ in products
             if a[-1] == rows == b[-2]]
    assert sorted((a[-2], b[-1]) for a, b, _ in grads) == [(d, n // TP)] * 2
    assert sum(f for _, _, f in grads) == 2 * 2 * rows * d * n // TP


def test_arctic_replay_runs_no_output_product(cuts):
    """arctic-480b ``train_4k``: the products of the shapes of the block's
    output products, the combine (n, g, E·C) by (n, E·C, d) on the rank's
    experts and the dense FFN's ``wo`` (B·S, F/16) by (F/16, d), run once
    a layer in the forward; in the backward only the gradients that share
    those shapes run (the dispatch's input gradient, and the dense FFN's
    ``wi`` and ``wg`` input gradients), none in the replay (before: the
    combine ran again in each layer's replay)."""
    cfg, _, products = cuts[ARCTIC, "train_4k"]
    sp, m, layers = SHAPES["train_4k"], cfg.moe, cfg.n_layers
    tokens = sp.global_batch // TP * sp.seq_len
    n, g = moe.group_split(tokens, m.group_size)
    ec = m.num_experts // TP * moe.capacity(cfg, g)
    f = cfg.dense_residual_ff // TP
    combine = ((n, g, ec), (n, ec, cfg.d_model))
    dense = ((1, tokens, f), (1, f, cfg.d_model))
    seen = collections.Counter((shapes, back) for shapes, _, back in products)
    assert seen[combine, False] == seen[combine, True] == layers
    assert seen[dense, False] == layers
    assert seen[dense, True] == 2 * layers
