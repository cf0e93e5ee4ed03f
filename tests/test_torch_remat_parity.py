"""The port's rematerialization against the JAX package's on the CPU, for
the decoder-only families: llama3.2-1b (dense GQA), phi3.5-moe (the dense
MoE, its router and aux loss) and deepseek-v2-236b (MLA and the shared
experts, at its config's ``"nothing"`` policy, and at ``"dots"`` for the
saved set). What each check holds, and to what tolerance, is in
``tests/_torch_remat.py`` and ``tests/_torch_llm_train.py``:

* with ``remat=True`` on both sides, ``registry.loss_fn``'s loss, ce, aux
  and every leaf's gradient against ``jax.value_and_grad`` within ``TOL``;
* per checkpointed layer, the multiset of the products the port's region
  keeps equals what JAX's ``jax.checkpoint(body)`` saves.
"""
import pytest

from tests import _torch_llm_train as T
from tests import _torch_remat as R

CASES = (("llama3.2-1b", "dots"), ("phi3.5-moe-42b-a6.6b", "dots"),
         ("deepseek-v2-236b", "nothing"))


@pytest.mark.parametrize("arch,policy", CASES)
def test_remat_loss_and_grads_match_jax(arch, policy, monkeypatch):
    T.check_loss_and_grads(arch, monkeypatch, remat=True,
                           remat_policy=policy)


@pytest.mark.parametrize("arch,policy", CASES + (("deepseek-v2-236b",
                                                  "dots"),))
def test_saved_products_equal_jax(arch, policy, monkeypatch):
    R.check_saved_set(arch, policy, monkeypatch)
