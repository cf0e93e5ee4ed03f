"""Shared checks of the port's ``serve_llm`` example against the JAX
package's ``examples/serve_llm.py`` on the CPU (``tests/test_torch_serve_llm.py``
and ``tests/test_torch_serve_llm_families.py`` run them per arch id).

The reference is the example's own steps, written here with the JAX
package's functions: ``init_params(cfg, PRNGKey(0))`` as the trainer's
weights, ``transfer.Sender(mode="patch+quant")`` and
``Receiver.materialize``, the prefix and first tokens drawn from
``PRNGKey(0)`` / ``PRNGKey(1)`` as the example draws them, the prefix decoded
at batch 1 through ``jax.jit(make_serve_step)``, the example's ``fan_out``
(dim 1 repeated where it is 1), then ``G`` greedy steps. For zamba2 that
``fan_out`` raises (its mamba states are stacked ``(n_super, P-1, B, ...)``),
so there the reference decodes the prefix at batch ``B``.

Each arch id's ``smoke()`` config (f32); B = 3, P = 4, G = 3. The trainer's
weights cross into the port by ``convert.params_from_numpy``. Tolerance:
``TOL`` = 1e-5, rtol and atol as a share of the largest |value| (the LLM
serving parity tests'); frames and materialized weights bit for bit;
tokens equal, with every step's top-2 logit margin in JAX above the logit
tolerance (``tests/test_torch_llm.py``'s guard), so equal tokens mean
something.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import transfer as j_transfer
from repro.models import registry as j_registry
from repro.train.steps import make_serve_step as j_make_serve_step
from repro_torch import convert, serve_llm
from repro_torch.kernels import _build
from repro_torch.models import registry

B, P, G = 3, 4, 3
TOL = 1e-5
HYBRID = "zamba2-7b"


def close(got, want, what, tol=TOL):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max(initial=0)),
                               err_msg=what)


def _example_fan_out(a):
    """``examples/serve_llm.py:55-58``."""
    if a.ndim >= 2 and a.shape[1] == 1:
        return jnp.repeat(a, B, axis=1)
    return a


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The JAX example's steps -> dict of numpy results: the trainer's
    weights, the frame, the materialized weights, prefix and first tokens,
    the fanned-out state (before the continuation), the tokens (B, 1 + G)
    and each continuation step's logits."""
    jcfg = j_registry.get_config(arch, smoke=True)
    key = jax.random.PRNGKey(0)
    trainer = j_registry.init_params(jcfg, key)
    snd = j_transfer.Sender(mode="patch+quant")
    rcv = j_transfer.Receiver()
    frame = snd.make_update(trainer)
    rcv.apply_update(frame)
    params = rcv.materialize("patch+quant", snd.manifest, like=trainer)
    serve = j_make_serve_step(jcfg)

    @jax.jit
    def step(p, st, t):  # the serve step, and its logits for the guard
        tok, new = serve(p, st, t)
        return tok, new, j_registry.decode_step(jcfg, p, st, t)[0]

    total = P + G + 1
    prefix = jax.random.randint(key, (P,), 0, jcfg.vocab_size)
    first = jax.random.randint(jax.random.PRNGKey(1), (B,), 0,
                               jcfg.vocab_size)
    if arch == HYBRID:
        shared = j_registry.init_decode_state(jcfg, B, total)
        for i in range(P):
            _, shared, _ = step(params, shared, jnp.repeat(prefix[i][None], B))
    else:
        state1 = j_registry.init_decode_state(jcfg, 1, total)
        for i in range(P):
            _, state1, _ = step(params, state1, prefix[i][None])
        shared = jax.tree_util.tree_map(_example_fan_out, state1)
    state, toks, outs, logits = shared, first, [first], []
    for _ in range(G):
        toks, state, lg = step(params, state, toks)
        outs.append(toks)
        logits.append(lg)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"trainer": to_np(trainer), "frame": frame,
            "params": to_np(params), "prefix": np.asarray(prefix),
            "first": np.asarray(first), "shared": to_np(shared),
            "tokens": np.asarray(jnp.stack(outs, 1)),
            "logits": [np.asarray(x) for x in logits]}


def port_inputs(arch):
    """(port config, trainer params on the CPU, prefix, first tokens)."""
    ref = reference(arch)
    return (registry.get_config(arch, smoke=True),
            convert.params_from_numpy(ref["trainer"], "cpu"),
            torch.from_numpy(ref["prefix"].copy()),
            torch.from_numpy(ref["first"].copy()))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def check_frame_and_weights(arch):
    """The frame equals JAX's bit for bit, and so does every materialized
    weight; the receive launches no kernel on CPU tensors."""
    ref = reference(arch)
    cfg, trainer, _, _ = port_inputs(arch)
    before = dict(_build.launches)
    params, frame, seconds = serve_llm.receive_weights(trainer, "cpu")
    assert list(seconds) == ["make_update", "apply_update", "materialize"]
    assert _build.launches == before
    assert frame == ref["frame"]
    n = 0
    for path, want in _leaves(ref["params"]):
        got = params
        for k in path:
            got = got[k]
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
        n += 1
    assert n == sum(1 for _ in _leaves(params))


def _shared_state(arch):
    cfg, trainer, prefix, _ = port_inputs(arch)
    params = convert.params_from_numpy(reference(arch)["params"], "cpu")
    state1 = serve_llm.decode_prefix(cfg, params, prefix, P + G + 1, "cpu")
    return cfg, params, state1


def check_fanned_state(arch):
    """The port's fanned-out state (prefix at batch 1, then ``fan_out``)
    against the JAX example's, leaf for leaf within ``TOL``; the position
    counter carried over."""
    ref = reference(arch)
    cfg, _, state1 = _shared_state(arch)
    fanned = serve_llm.fan_out(state1, serve_llm.batch_axes(cfg, "cpu"), B)
    want = dict(_leaves(ref["shared"]))
    got = dict(_leaves(fanned))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if path[-1] == "pos":
            assert g == int(w) == P
        else:
            assert g.is_contiguous(), path
            close(g, w, str(path))


def check_fan_out_copies_are_independent(arch):
    """Every batched leaf of the fanned-out state owns its memory: writing
    one request's row moves no other row, nor the batch-1 state."""
    cfg, _, state1 = _shared_state(arch)
    axes = serve_llm.batch_axes(cfg, "cpu")
    fanned = serve_llm.fan_out(state1, axes, B)
    ax = dict(_leaves(axes))
    one = dict(_leaves(state1))
    n = 0
    for path, leaf in _leaves(fanned):
        if not isinstance(leaf, torch.Tensor):
            continue
        assert leaf.untyped_storage().data_ptr() != \
            one[path].untyped_storage().data_ptr(), path
        if ax[path] is None:
            continue
        before = leaf.clone()
        leaf.select(ax[path], 1).fill_(7)
        for b in range(B):
            row = leaf.select(ax[path], b)
            want = torch.full_like(row, 7) if b == 1 else \
                before.select(ax[path], b)
            assert torch.equal(row, want), (path, b)
        assert torch.equal(one[path].select(ax[path], 0),
                           before.select(ax[path], 0)), path
        n += 1
    assert n > 0


def check_continuation(arch):
    """The fanned-out batch's greedy tokens equal JAX's; every step's top-2
    margin in JAX exceeds the logit tolerance."""
    ref = reference(arch)
    cfg, params, state1 = _shared_state(arch)
    fanned = serve_llm.fan_out(state1, serve_llm.batch_axes(cfg, "cpu"), B)
    with torch.inference_mode():
        got = serve_llm.continue_batch(cfg, params, fanned,
                                       torch.from_numpy(ref["first"].copy()), G)
    assert got.dtype == torch.int32 and got.shape == (B, 1 + G)
    for i, lg in enumerate(ref["logits"]):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > TOL * float(np.abs(lg).max()) + TOL * float(
            np.abs(top2).max()), f"step {i}: top-2 margin {margin}"
    np.testing.assert_array_equal(got.numpy(), ref["tokens"])


def check_run_shared_equals_alone(arch):
    """``serve_llm.run``: the shared route's tokens equal JAX's, and each
    request decoded alone equals its fanned-out row, with no flip."""
    ref = reference(arch)
    cfg, trainer, prefix, first = port_inputs(arch)
    out = serve_llm.run(cfg, trainer, prefix, first, G, "cpu")
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(out["alone"].numpy(), ref["tokens"])
    assert out["flips"] == [] and out["min_gap"] > 0
    assert out["frame_bytes"] == len(ref["frame"])


def check_cli(arch):
    """``python -m repro_torch.serve_llm --arch ... --smoke --device cpu``."""
    out = serve_llm.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prefix-len", "3",
                          "--gen-len", "2"])
    assert out["tokens"].shape == (2, 3) and out["flips"] == []
