"""The port's ``python -m repro_torch.serve_llm`` against the JAX package's
``examples/serve_llm.py`` on the CPU, for the other families: mamba2-130m
(``ssm``), zamba2-7b (``hybrid``), seamless-m4t-large-v2 (``encdec``: self
and cross caches) and deepseek-v2-236b (MLA's latent cache). The JAX
example's ``fan_out`` raises for zamba2, whose mamba states carry the batch
in dim 2; there the reference decodes the prefix at batch B. What each
check holds, and to what tolerance, is in ``tests/_torch_serve_llm.py``.
"""
import pytest

from tests import _torch_serve_llm as T

ARCHS = ("mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2",
         "deepseek-v2-236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_frame_and_weights_bit_for_bit(arch):
    T.check_frame_and_weights(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_fanned_state_matches_example(arch):
    T.check_fanned_state(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_fan_out_copies_are_independent(arch):
    T.check_fan_out_copies_are_independent(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuation_matches_example(arch):
    T.check_continuation(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_route_equals_requests_alone(arch):
    T.check_run_shared_equals_alone(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_runs(arch):
    T.check_cli(arch)


def test_example_fan_out_fails_for_zamba2():
    """The reason zamba2's reference takes another route: the JAX example's
    rule repeats zamba2's KV caches (batch in dim 1) but not its mamba
    states (batch in dim 2), and the decode step then fails to concatenate
    them; the port's ``batch_axes`` finds dim 2."""
    import jax
    from repro.models import registry as j_registry
    from repro_torch import serve_llm
    from repro_torch.models import registry

    jcfg = j_registry.get_config(T.HYBRID, smoke=True)
    fanned = jax.tree_util.tree_map(
        T._example_fan_out, j_registry.init_decode_state(jcfg, 1, 4))
    assert fanned["mamba"]["conv"].shape[2] == 1
    assert fanned["attn"]["k"].shape[1] == T.B
    axes = serve_llm.batch_axes(registry.get_config(T.HYBRID, smoke=True),
                                "cpu")
    assert axes["mamba"]["conv"] == 2 and axes["attn"]["k"] == 1
    assert axes["tail"]["conv"] == 1 and axes["pos"] is None
