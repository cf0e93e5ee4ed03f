"""The port's ``python -m repro_torch.serve_llm`` against the JAX package's
``examples/serve_llm.py`` on the CPU, for the six GQA arch ids (``dense``,
``vlm`` and ``moe`` without MLA). What each check holds, and to what
tolerance, is in ``tests/_torch_serve_llm.py``:

* the quantized frame and the materialized weights equal JAX's bit for bit;
* the state fanned out from the prefix decoded at batch 1 matches the
  example's ``fan_out``; the fan-out's rows own their memory;
* the continuation's tokens equal JAX's, with the top-2 margin guard;
* ``serve_llm.run``: each request decoded alone equals its fanned-out row;
* the command line runs at the smoke config.
"""
import pytest

from tests import _torch_serve_llm as T

ARCHS = ("llama3.2-1b", "qwen2.5-3b", "granite-8b", "yi-6b", "chameleon-34b",
         "phi3.5-moe-42b-a6.6b")


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
