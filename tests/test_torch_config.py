"""The port's config registry equals the JAX package's, field by field."""
import dataclasses

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_optimizer_name as jax_optimizer
from repro_torch.configs import ARCH_IDS as TORCH_ARCH_IDS
from repro_torch.configs import get_config, get_optimizer_name

FORMS = {"full": {}, "smoke": {"smoke": True}, "optimized": {"optimized": True}}
DERIVED = ("n_groups", "n_tail", "tail_pattern", "padded_vocab", "rnn_width",
           "is_recurrent", "sub_quadratic")


def test_same_arch_ids():
    assert TORCH_ARCH_IDS == ARCH_IDS


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_match(arch, form):
    got = get_config(arch, **FORMS[form])
    want = jax_config(arch, **FORMS[form])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name
    if want.moe is not None:
        assert got.d_expert_eff == want.d_expert_eff


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_name_matches(arch):
    assert get_optimizer_name(arch) == jax_optimizer(arch)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")
