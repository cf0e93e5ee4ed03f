"""The port's LLM training path against the JAX package on the CPU: the
encoder-decoder (seamless-m4t-large-v2: LayerNorm, the ReLU FFN, unmasked
and cross attention through the flash wrapper with Sq != Sk), the SSM
(mamba2-130m: the SSD scan, softplus, the causal conv), the hybrid (zamba2-7b:
the shared block's LoRA, attention at head dim 112 once per super-block) and
deepseek-v2-236b (MLA's expanded forward at qk / v 48 / 32, the shared
experts, the routers' aux loss). What each check holds, and to what
tolerance, is in ``tests/_torch_llm_train.py``:

* ``registry.loss_fn``'s loss, ce, aux and every leaf's gradient against
  ``jax.value_and_grad``; deepseek's routed tokens stand away from a tie;
* three ``make_train_step`` Adam steps on one batch: finite and falling;
  each step's loss beside JAX's from JAX's state;
* ``make_prefill_step``'s logits against JAX's.
"""
import pytest

from tests import _torch_llm_train as T

ARCHS = ("seamless-m4t-large-v2", "mamba2-130m", "zamba2-7b",
         "deepseek-v2-236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch, monkeypatch):
    T.check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_fall_and_match(arch):
    T.check_train_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches(arch):
    T.check_prefill_step(arch)
