"""The port's parameter and FLOP accounting (``repro_torch/common/
counting.py``, ``ModelConfig.param_count``) against the JAX package's.

For each of the JAX package's ten arch ids, ``config()`` and ``smoke()``
(every branch: dense, vlm, moe with and without shared experts, MLA, ssm,
hybrid, encdec), rebuilt field for field as the port's ``ModelConfig``:
``param_count`` with ``active_only`` both ways and ``model_flops`` for a
forward and a training step equal JAX's exactly, as integers. For every
ported arch id the analytic count is within 2% of its spec tree
(``test_archs.py::test_param_count_matches_specs``' twin).
"""
import dataclasses

import pytest

from repro.common import counting as j_counting
from repro.models import registry as j_registry
from repro_torch.common import counting, pspec
from repro_torch.common.config import ModelConfig
from repro_torch.models import registry


def _port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def test_every_branch_is_covered():
    cfgs = [j_registry.get_config(a) for a in j_registry.ARCH_IDS]
    assert {c.family for c in cfgs} == {"dense", "vlm", "moe", "ssm",
                                        "hybrid", "encdec"}
    assert any(c.attn_kind == "mla" for c in cfgs)
    assert any(c.n_shared_experts for c in cfgs)
    assert any(c.qkv_bias for c in cfgs)


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_counts_equal_jax(arch, smoke):
    jcfg = j_registry.get_config(arch, smoke=smoke)
    cfg = _port_config(jcfg)
    for active in (False, True):
        got = cfg.param_count(active_only=active)
        want = jcfg.param_count(active_only=active)
        assert type(got) is int and got == want, (active, got, want)
        assert counting.param_count(cfg, active) == \
            j_counting.param_count(jcfg, active)
    for kind in ("forward", "train"):
        n_tokens = 4 * 1024
        assert counting.model_flops(cfg, n_tokens, kind) == \
            j_counting.model_flops(jcfg, n_tokens, kind)
    if cfg.is_moe:
        assert cfg.param_count(True) < cfg.param_count()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_count_matches_specs(arch):
    cfg = registry.get_config(arch)
    analytic = cfg.param_count()
    true = pspec.count(registry.param_specs(cfg))
    assert abs(analytic - true) / true < 0.02, (arch, analytic, true)


def test_unknown_family_raises():
    with pytest.raises(ValueError):
        counting.param_count(ModelConfig(family="rnn"))
