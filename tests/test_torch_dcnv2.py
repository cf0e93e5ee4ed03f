"""The port's DCNv2 baseline (``repro_torch/core/dcnv2.py``) against the JAX
package's on the CPU.

``test_paper_core.py``'s config (F = 12, V = 2^14) and its batches from
``CTRStream``; JAX's ``init_params(PRNGKey(0))`` weights carried into the
port by ``convert.params_from_numpy``:

* the spec tree equals JAX's leaf for leaf;
* ``forward`` and ``loss_fn`` within rtol 1e-5 and atol 1e-5 of the largest
  |value|, with the default widths and with fewer cross and MLP layers
  (the loops that stop at the first missing leaf);
* the gradients of the loss within the round-step tolerances (rtol 2e-4,
  atol 1e-6);
* ``test_dcnv2_trains``' twin: 30 SGD steps of 512 at lr 0.05 on
  ``CTRStream(seed=8)`` from the port's own seed-0 weights, and the loss
  falls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pspec as j_pspec
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import dcnv2 as j_dcnv2
from repro.data.synthetic import CTRStream as JCTRStream
from repro_torch import convert
from repro_torch.common import pspec
from repro_torch.common.config import FFMConfig
from repro_torch.core import dcnv2
from repro_torch.data.synthetic import CTRStream

KW = dict(n_fields=12, context_fields=8, hash_space=2**14, k=4,
          mlp_hidden=(16, 8))
CFG, JCFG = FFMConfig(**KW), JFFMConfig(**KW)
TOL = 1e-5  # rtol, and atol as a share of the largest |value|
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
# (n_cross, mlp_hidden): the defaults, then fewer cross layers and one
# hidden layer, then no cross layer and no hidden layer
WIDTHS = [(3, (64, 32)), (2, (16,)), (0, ())]


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _params(n_cross=3, mlp_hidden=(64, 32)):
    jp = j_dcnv2.init_params(JCFG, jax.random.PRNGKey(0), n_cross=n_cross,
                             mlp_hidden=mlp_hidden)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, convert.params_from_numpy(tree, "cpu")


def _batch(seed=8, n=512):
    b = JCTRStream(JCFG, seed=seed).sample(n)
    return b, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("n_cross,mlp_hidden", WIDTHS)
def test_param_specs_match(n_cross, mlp_hidden):
    theirs = j_dcnv2.param_specs(JCFG, n_cross, mlp_hidden=mlp_hidden)
    ours = dcnv2.param_specs(CFG, n_cross, mlp_hidden)
    assert sorted(ours) == sorted(theirs)
    for name, s in ours.items():
        t = theirs[name]
        assert (s.shape, s.axes, s.init, s.fan_in) == \
            (t.shape, t.axes, t.init, t.fan_in), name
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(t.dtype).name
    assert pspec.count(ours) == j_pspec.count(theirs)
    p = dcnv2.init_params(CFG, 0, "cpu", n_cross, mlp_hidden)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: s.shape for k, s in ours.items()}


@pytest.mark.parametrize("n_cross,mlp_hidden", WIDTHS)
def test_forward_and_loss_match(n_cross, mlp_hidden):
    jp, tp = _params(n_cross, mlp_hidden)
    jb, tb = _batch()
    got = dcnv2.forward(CFG, tp, tb["idx"], tb["val"])
    want = j_dcnv2.forward(JCFG, jp, jnp.asarray(jb["idx"]),
                           jnp.asarray(jb["val"]))
    assert got.shape == (512,) and got.dtype == torch.float32
    _close(got, want, what="logits")
    _close(dcnv2.loss_fn(CFG, tp, tb), j_dcnv2.loss_fn(JCFG, jp, jb),
           what="loss")


def test_gradients_match():
    jp, tp = _params()
    jb, tb = _batch(seed=2)
    for v in tp.values():
        v.requires_grad_(True)
    loss = dcnv2.loss_fn(CFG, tp, tb)
    grads = torch.autograd.grad(loss, list(tp.values()))
    jg = jax.grad(lambda p: j_dcnv2.loss_fn(JCFG, p, jb))(jp)
    for (name, _), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # the embedding's gradient lands on the batch's rows only
    untouched = torch.ones(CFG.hash_space, dtype=torch.bool)
    untouched[torch.from_numpy(np.unique(jb["idx"]))] = False
    assert not bool(grads[list(tp).index("emb")][untouched].any())


def test_dcnv2_trains():
    """``test_paper_core.py::test_dcnv2_trains``' twin on the port."""
    stream = CTRStream(CFG, seed=8)
    params = dcnv2.init_params(CFG, 0, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    losses = []
    for b in stream.batches(512, 30):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        loss = dcnv2.loss_fn(CFG, params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= 0.05 * g
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        dcnv2.init_params(CFG)
