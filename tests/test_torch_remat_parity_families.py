"""The port's rematerialization against the JAX package's on the CPU, for
the encoder-decoder (seamless-m4t-large-v2: an encoder region and a
decoder region per layer, the cross keys and values inside the decoder's),
the SSM (mamba2-130m: one region per block) and the hybrid (zamba2-7b: one
region per super-block, the tail blocks outside). What each check holds,
and to what tolerance, is in ``tests/_torch_remat.py`` and
``tests/_torch_llm_train.py``:

* with ``remat=True`` (``"dots"``) on both sides, ``registry.loss_fn``'s
  loss, ce, aux and every leaf's gradient against ``jax.value_and_grad``
  within ``TOL``;
* per region, the multiset of the products the port keeps equals what
  JAX's checkpointed body saves; under ``"nothing"`` neither keeps one.
"""
import pytest

from tests import _torch_llm_train as T
from tests import _torch_remat as R

ARCHS = ("seamless-m4t-large-v2", "mamba2-130m", "zamba2-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_match_jax(arch, monkeypatch):
    T.check_loss_and_grads(arch, monkeypatch, remat=True,
                           remat_policy="dots")


@pytest.mark.parametrize("policy", ("dots", "nothing"))
@pytest.mark.parametrize("arch", ARCHS)
def test_saved_products_equal_jax(arch, policy, monkeypatch):
    R.check_saved_set(arch, policy, monkeypatch)
