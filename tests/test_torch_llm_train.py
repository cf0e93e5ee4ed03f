"""The port's LLM training path against the JAX package on the CPU: the
``dense`` / ``vlm`` / ``moe`` GQA arch ids (llama3.2-1b, granite-8b, yi-6b,
qwen2.5-3b with QKV biases, chameleon-34b with QK norms, phi3.5-moe with the
dense-combine MoE and its aux loss), and the pieces of the step:

* per arch id (``tests/_torch_llm_train.py`` holds each check and its
  tolerance, 1e-4 of each tensor's largest |value|): ``registry.loss_fn``'s
  loss, ce, aux and every leaf's gradient against ``jax.value_and_grad``
  (phi's routed tokens stand away from a tie); three ``make_train_step``
  Adam steps on one batch, finite and falling, each step's loss beside
  JAX's from JAX's state; ``make_prefill_step``'s logits against JAX's;
* ``layers.cross_entropy`` with some labels masked and with every label
  masked (0, as the JAX package's ``max(count, 1)`` gives), within 1e-6;
* the port's ``adam`` update against JAX's from the same gradients, params
  and state, at steps 0 and 7, within 1e-6 relative;
* ``lm_batches`` equal to JAX's for seeds 0 and 1, with
  ``test_data.py::test_lm_batches_shapes``' twin;
* ``transformer.unstack`` gives each layer's views into the stacks;
* ``python -m repro_torch.launch.train --smoke --device cpu --steps 2`` runs,
  and its ``--ckpt`` round-trips through ``store.load``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import layers as j_layers
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.models import layers, registry, transformer
from repro_torch.optim.optimizers import make_optimizer
from tests import _torch_llm_train as T

ARCHS = ("llama3.2-1b", "granite-8b", "yi-6b", "qwen2.5-3b", "chameleon-34b",
         "phi3.5-moe-42b-a6.6b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch, monkeypatch):
    T.check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_fall_and_match(arch):
    T.check_train_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches(arch):
    T.check_prefill_step(arch)


@pytest.mark.parametrize("masked", ["some", "all"])
def test_cross_entropy_masks_labels(masked):
    rng = np.random.default_rng(0)
    lg = (rng.normal(size=(3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    if masked == "all":
        labels[:] = -1
    else:
        labels[0, :3] = -1
        labels[2, -1] = -5
    got = layers.cross_entropy(torch.from_numpy(lg), torch.from_numpy(labels),
                               40)
    want = j_layers.cross_entropy(jnp.asarray(lg), jnp.asarray(labels), 40)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    if masked == "all":
        assert float(got) == 0.0


@pytest.mark.parametrize("step", [0, 7])
def test_adam_matches(step):
    rng = np.random.default_rng(step)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 2, 4)}}

    def tree(scale):
        def make(s):
            return {k: make(v) for k, v in s.items()} if isinstance(
                s, dict) else (rng.normal(size=s) * scale).astype(np.float32)
        return make(shapes)

    params, grads = tree(1.0), tree(0.1)
    state = {"m": tree(0.01), "v": jax.tree_util.tree_map(np.abs, tree(1e-3))}
    jopt, opt = j_make_optimizer("adam", lr=1e-3), make_optimizer("adam",
                                                                  lr=1e-3)
    jp, js = jopt.update(*(jax.tree_util.tree_map(jnp.asarray, t)
                           for t in (grads, state, params)),
                         jnp.asarray(step, jnp.int32))
    tp, ts = opt.update(*(convert.params_from_numpy(t, "cpu")
                          for t in (grads, state, params)), step)
    for got, want in ((tp, jp), (ts, js)):
        for g, w in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_updates_large_leaves_in_slices_bit_for_bit(dtype, weight_decay,
                                                        monkeypatch):
    """A leaf past ``ADAM_CHUNK`` weights is updated slice by slice along
    its first dim into its new tensors: the same bits as the update of the
    leaf in one slice (a strided leaf slices the same way, a row past
    ``ADAM_CHUNK`` is a slice of its own)."""
    from repro_torch.optim import optimizers
    g = torch.Generator().manual_seed(3)
    base = torch.randn(6, 41, generator=g)
    params = {"a": base.to(dtype), "b": {"c": torch.randn(
        9, generator=g).to(dtype), "t": base.T.to(dtype)}}
    grads = optimizers._map(lambda p: torch.randn(
        p.shape, generator=g).to(dtype), params)
    state = {"m": optimizers._map(lambda p: torch.randn(
                 p.shape, generator=g), params),
             "v": optimizers._map(lambda p: torch.rand(
                 p.shape, generator=g), params)}
    opt = make_optimizer("adam", lr=1e-3, weight_decay=weight_decay)
    want = opt.update(grads, state, params, 5)
    monkeypatch.setattr(optimizers, "ADAM_CHUNK", 16)
    got = opt.update(grads, state, params, 5)
    for w, t in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert t.dtype == w.dtype and torch.equal(t, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_batches_match_reference(seed):
    got = list(lm_batches(vocab=300, batch=3, seq=20, n=3, seed=seed))
    want = list(j_lm_batches(vocab=300, batch=3, seq=20, n=3, seed=seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tokens", "labels"}
        for key in g:
            assert g[key].dtype == w[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], w[key])


def test_lm_batches_shapes():
    b = next(lm_batches(vocab=100, batch=4, seq=16, n=1))
    assert b["tokens"].shape == (4, 16)
    assert b["labels"].shape == (4, 16)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


def test_unstack_gives_layer_views():
    cfg = registry.get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    tp = registry.init_params(cfg, 0, "cpu")
    layers_ = transformer.unstack(tp["layers"])
    assert len(layers_) == cfg.n_layers
    stacks = dict(T._leaves(tp["layers"]))
    for i, lp in enumerate(layers_):
        got = dict(T._leaves(lp))
        assert got.keys() == stacks.keys()
        for name, stack in stacks.items():
            assert torch.equal(got[name], stack[i]), (i, name)
            assert got[name].data_ptr() == stack[i].data_ptr()


def test_train_launcher_runs_and_checkpoints(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                           "cpu", "--steps", "2", "--ckpt", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "step 1: loss=" in out
    assert "llama3.2-1b on cpu: 2 steps of 4x32 tokens" in out
    cfg = registry.get_config("llama3.2-1b", smoke=True)
    like = registry.init_params(cfg, 0, "cpu")
    opt_like = make_optimizer("adam").init(like)
    params, opt_state = store.load(str(ckpt), like, opt_like, device="cpu")
    assert opt_state is not None
    for (name, p), (_, p0) in zip(T._leaves(params), T._leaves(like)):
        assert p.shape == p0.shape and p.dtype == p0.dtype, name
        assert not torch.equal(p, p0), f"{name} did not train"
    for (name, m), (_, m0) in zip(T._leaves(opt_state),
                                  T._leaves(opt_like)):
        assert m.shape == m0.shape and bool(torch.isfinite(m).all()), name
