"""The port's cross-entropy (``repro_torch.models.loss``) on the CPU.

* Off a mesh, bit for bit against the whole-tensor formulas it replaced
  (``torch.logsumexp`` and ``torch.gather`` of the fp32 logits under
  autograd): the loss, the logits' gradient and every parameter's
  gradient, fp32 and bf16, phi4-mini-3.8b's padded vocab and gemma-7b's
  tied head, a mask with zeros, over at least 3 chunks of rows.
* ``loss_fn`` against the JAX package's through ``jax.value_and_grad``
  (gemma-7b and recurrentgemma-2b smoke, in chunks, a mask with zeros),
  within ``test_torch_model.py``'s tolerances.
* phi4-mini-3.8b cut to 2 layers at ``train_4k`` on 16 x 16 (256 fake
  ranks, fake CPU tensors): no fp32 tensor of the logits' local shape at
  the peak, the peak at least three such tensors under the whole-tensor
  loss's, and the FLOPs unchanged.
The sharded route runs in ``test_torch_sharding.py``'s (2, 2) ``gloo``
steps against JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jt
from repro_torch.configs import SHAPES, get_config, get_optimizer_name
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.models import loss as tl
from repro_torch.models import transformer as tt
from repro_torch.tree import leaves, tree_map

B, S = 2, 16
ROWS = 5                 # rows a chunk under the lowered budget
GIB = 2 ** 30


def _batch(vocab: int, b: int, s: int, seed: int = 1):
    """tokens, labels and a mask with zeros, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1))
    mask = (rng.random((b, s)) > 0.25).astype(np.float32)
    assert 0 < mask.sum() < mask.size
    return toks[:, :-1], toks[:, 1:], mask


def _chunked(monkeypatch, rows: int, vocab: int) -> None:
    """Lower the chunk budget to ``ROWS`` rows of ``vocab`` and check that
    ``rows`` rows make at least 3 chunks."""
    monkeypatch.setattr(tl, "CE_CHUNK_BYTES", ROWS * 4 * vocab)
    assert len(tl._row_spans(rows, vocab)) >= 3


def _whole_tensor_loss(params, batch, cfg):
    """``loss_fn`` as written before the chunked cross-entropy."""
    logits, aux = tt.forward(params, batch, cfg)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, batch["labels"][..., None].long())
    nll = (logz[..., None] - label_logit)[..., 0]
    mask = batch["mask"]
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux["aux_loss"] + aux["z_loss"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b"])
def test_chunked_loss_is_the_whole_tensor_formulas_bit_for_bit(
        arch, dtype, monkeypatch):
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    assert cfg.padded_vocab > cfg.vocab
    _chunked(monkeypatch, B * S, cfg.padded_vocab)
    toks, labels, mask = _batch(cfg.vocab, B, S)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)}
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)

    # the loss and the logits' gradient
    logits, _ = tt.forward(params, batch, cfg)
    x = [logits.detach().clone().requires_grad_() for _ in range(2)]
    nll = tl.cross_entropy(x[0], batch["labels"])
    assert nll.dtype == torch.float32 and nll.shape == (B, S)
    lf = x[1].float()
    want = (torch.logsumexp(lf, -1)[..., None]
            - torch.gather(lf, -1, batch["labels"][..., None].long()))[..., 0]
    assert torch.equal(nll, want)
    m = batch["mask"]
    (gx,), (wx,) = (torch.autograd.grad((n * m).sum() / m.sum(), [t])
                    for n, t in ((nll, x[0]), (want, x[1])))
    assert gx.dtype == logits.dtype and torch.equal(gx, wx)

    # ``loss_fn`` and every parameter's gradient
    got_p, want_p = (tree_map(lambda t: t.detach().clone().requires_grad_(),
                              params) for _ in range(2))
    loss, metrics = tt.loss_fn(got_p, batch, cfg)
    whole = _whole_tensor_loss(want_p, batch, cfg)
    assert torch.equal(loss, whole)
    got_g = torch.autograd.grad(loss, list(leaves(got_p)))
    want_g = torch.autograd.grad(whole, list(leaves(want_p)))
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-2b"])
def test_loss_fn_matches_the_references(arch, monkeypatch):
    """Value and every gradient leaf against ``jax.value_and_grad`` of the
    JAX package's ``loss_fn``: loss rtol 1e-5, gradients 1e-4."""
    s = 64
    jc, tc = (f(arch, smoke=True) for f in (jax_config, get_config))
    _chunked(monkeypatch, B * s, tc.padded_vocab)
    jp = jt.init_params(jax.random.PRNGKey(3), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks, labels, mask = _batch(jc.vocab, B, s, seed=5)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32), "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "mask": torch.from_numpy(mask)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                                  static_argnums=2)(jp, jb, jc)
    loss, metrics = tt.loss_fn(tp, tb, tc)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=1e-5)
    tree_map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4), tp, jgrads)


# phi4-mini-3.8b cut to 2 layers at train_4k on 16 x 16: the peak local
# bytes the cut held with the whole-tensor loss (its fp32 copy of the
# logits, the backward's x - logz, its exp and g times it, each (16, 4096,
# 12512) fp32), and its FLOPs a device, which the loss does not move
WHOLE_LOSS_PEAK = 16154910228
LOGITS_F32_BYTES = 4 * 16 * 4096 * 12512
TWO_LAYER_FLOPS = "2.4700e+13"


@pytest.fixture(scope="module")
def phi4_two_layers():
    cfg = get_config("phi4-mini-3.8b").replace(n_layers=2,
                                               use_flash_kernel=True)
    with dryrun.fake_process_group(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        return dryrun.trace_step(cfg, SHAPES["train_4k"], mesh,
                                 get_optimizer_name("phi4-mini-3.8b"))


def test_no_fp32_logits_at_the_peak(phi4_two_layers):
    c = phi4_two_layers["counts"]
    print(f"\nphi4-mini-3.8b, 2 layers, train_4k 16x16: peak "
          f"{c.peak_bytes / GIB:.2f} GiB (whole-tensor loss "
          f"{WHOLE_LOSS_PEAK / GIB:.2f}); largest live at the peak: "
          f"{c.peak_tensors}")
    assert f"{c.flops:.4e}" == TWO_LAYER_FLOPS
    assert not [t for t in c.peak_tensors if t["dtype"] == "torch.float32"
                and t["bytes"] >= LOGITS_F32_BYTES]
    assert c.peak_bytes <= WHOLE_LOSS_PEAK - 3 * LOGITS_F32_BYTES
