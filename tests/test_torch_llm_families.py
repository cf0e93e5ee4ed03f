"""The port's other GQA families against the JAX package on the CPU.

phi3.5-moe (``moe``: the dense-combine MoE FFN), granite-8b and yi-6b
(``dense``), qwen2.5-3b (``dense`` with QKV biases and tied embeddings) and
chameleon-34b (``vlm`` with QK norms), each at its ``smoke()`` size in f32,
with the JAX package's ``init_params(PRNGKey(0))`` weights carried into the
port by ``convert.params_from_numpy``. QKV biases and QK norms initialize to
zeros and ones, which would test nothing, so both sides get the same seeded
values for them. Tolerance: rtol 1e-5 and atol 1e-5 of the largest |value|
(``tests/test_torch_llm.py``'s):

* ``forward`` logits and the routers' aux loss; ``prefill`` (last logits,
  the cache's first S slots) and 8 ``decode_step``s after it;
* ``LLMServer.generate`` returns JAX's tokens (``moe`` and the int8 cache by
  the stepwise warm-up, as JAX's server), with every step's top-2 logit
  margin in JAX above the logit tolerance;
* ``moe_dense``'s output, aux and chosen experts, with the gap between the
  k-th and (k+1)-th router probability above the tolerance; ``_aux_loss``
  is 1 on balanced routing;
* the int8 cache: ``_quantize_kv`` codes and scales bit for bit, and int8
  decode step by step from JAX's own cache handed across before each step:
  codes bit-equal except where JAX's pre-rounding value lies within the
  tolerance of a half (counted and printed), logits within the tolerance
  where the codes agree;
* the port's decode against its own forward within ``test_archs.py``'s rel
  < 5e-3 (native cache) and < 0.05 (int8 cache);
* bf16 weights cross bit for bit and the router stays f32;
* ``python -m repro_torch.launch.serve --smoke --device cpu`` runs.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.serving.server import LLMServer as JLLMServer
from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, moe, registry, transformer
from repro_torch.serving.server import LLMServer

ARCHS = ("phi3.5-moe-42b-a6.6b", "granite-8b", "yi-6b", "qwen2.5-3b",
         "chameleon-34b")
PHI = "phi3.5-moe-42b-a6.6b"
SEED = 0
TOL = 1e-5  # rtol, and atol as a share of the largest |value|
B, S, STEPS = 2, 12, 8


def _close(got, want, tol=TOL, what=""):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _params(arch, dtype="float32", **kw):
    """(JAX config, JAX params, port config, port params on the CPU), the
    biases and QK norms seeded on both sides."""
    jcfg = j_registry.get_config(arch, smoke=True).replace(
        dtype=dtype, param_dtype=dtype, **kw)
    cfg = registry.get_config(arch, smoke=True).replace(
        dtype=dtype, param_dtype=dtype, **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, j_registry.init_params(jcfg, jax.random.PRNGKey(SEED)))
    rng = np.random.default_rng(7)
    attn = tree["layers"]["attn"]
    for name, base in (("bq", 0.0), ("bk", 0.0), ("bv", 0.0),
                       ("q_norm", 1.0), ("k_norm", 1.0)):
        if name in attn:
            attn[name] = (base + rng.normal(0, 0.5, attn[name].shape)).astype(
                attn[name].dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, cfg, convert.params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return _params(request.param)


def _tokens(cfg, shape, seed=SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _seeded_attention(cfg, tp):
    """The seeded leaves are really there, and are not zeros / ones."""
    attn = tp["layers"]["attn"]
    for flag, names in ((cfg.qkv_bias, ("bq", "bk", "bv")),
                        (cfg.qk_norm, ("q_norm", "k_norm"))):
        for name in names:
            assert (name in attn) == flag, name
            if flag:
                assert float(attn[name].std()) > 0.1, name


def test_forward_matches(f32):
    jcfg, jp, cfg, tp = f32
    _seeded_attention(cfg, tp)
    toks = _tokens(cfg, (B, 16))
    got, aux = registry.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    want, jaux = j_registry.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, 16, cfg.padded_vocab)
    _close(got, want, what="logits")
    _close(aux, jaux, what="aux")
    assert (float(aux) > 0) == cfg.is_moe


def test_prefill_then_decode_match(f32):
    """Prefill 12 tokens, then 8 decode steps on fixed tokens."""
    jcfg, jp, cfg, tp = f32
    prompt, feed = _tokens(cfg, (B, S)), _tokens(cfg, (STEPS, B), seed=5)
    jstate = j_registry.init_decode_state(jcfg, B, S + STEPS + 1)
    tstate = registry.init_decode_state(cfg, B, S + STEPS + 1, device="cpu")
    before = dict(_build.launches)
    got, tstate = transformer.prefill(cfg, tp, torch.from_numpy(prompt),
                                      tstate)
    want, jstate = j_transformer.prefill(jcfg, jp, jnp.asarray(prompt),
                                         jstate)
    _close(got, want, what="prefill logits")
    assert tstate["pos"] == int(jstate["pos"]) == S
    for name in ("k", "v"):
        _close(tstate["cache"][name][:, :, :S],
               np.asarray(jstate["cache"][name])[:, :, :S],
               what=f"prefill cache {name}")
    for i in range(STEPS):
        got, tstate = registry.decode_step(cfg, tp, tstate,
                                           torch.from_numpy(feed[i]))
        want, jstate = j_registry.decode_step(jcfg, jp, jstate,
                                              jnp.asarray(feed[i]))
        _close(got, want, what=f"decode step {i}")
    for name in ("k", "v"):
        _close(tstate["cache"][name], jstate["cache"][name],
               what=f"cache {name} after decode")
    assert _build.launches == before  # CPU tensors: no kernel


def _jax_warm_logits(jcfg, jp, prompts, gen_len):
    """JAX's logits behind the first generated token, by the path JAX's
    server takes (batched prefill, or the stepwise warm-up)."""
    b, p = prompts.shape
    state = j_registry.init_decode_state(jcfg, b, p + gen_len + 1)
    if (jcfg.family in ("dense", "vlm")
            and jcfg.kv_cache_dtype == "native"):
        return j_transformer.prefill(jcfg, jp, jnp.asarray(prompts), state)
    for i in range(p):
        lg, state = j_registry.decode_step(jcfg, jp, state,
                                           jnp.asarray(prompts[:, i]))
    return lg, state


@pytest.mark.parametrize("arch,kv", [(a, "native") for a in ARCHS]
                         + [("qwen2.5-3b", "int8")])
def test_generate_matches(arch, kv):
    jcfg, jp, cfg, tp = _params(arch, kv_cache_dtype=kv)
    prompts, gen_len = _tokens(cfg, (B, S)), 8
    want = np.asarray(JLLMServer(jcfg, jp).generate(jnp.asarray(prompts),
                                                    gen_len))
    server = LLMServer(cfg, tp, device="cpu")
    got = server.generate(torch.from_numpy(prompts), gen_len)
    assert got.dtype == torch.int32 and got.shape == (B, gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert server.stats.requests == B and server.stats.candidates == B * gen_len
    # the top two logits behind every greedy choice must differ by more
    # than the logit tolerance for equal tokens to mean something
    lg, state = _jax_warm_logits(jcfg, jp, prompts, gen_len)
    for i in range(gen_len):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > TOL * float(np.abs(lg).max()) + TOL * float(
            np.abs(top2).max()), f"step {i}: top-2 margin {margin}"
        np.testing.assert_array_equal(lg.argmax(-1), want[:, i])
        lg, state = j_registry.decode_step(jcfg, jp, state,
                                           jnp.asarray(want[:, i]))


@pytest.fixture(scope="module")
def phi():
    return _params(PHI)


def test_moe_dense_matches(phi):
    jcfg, jp, cfg, tp = phi
    x = np.random.default_rng(3).normal(size=(B, 16, cfg.d_model)).astype(
        np.float32)
    for layer in range(cfg.n_layers):
        jm = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"])["moe"]
        tm = transformer.unstack(tp["layers"])[layer]["moe"]
        assert tm["router"].dtype == torch.float32
        y, aux = moe.moe_dense(cfg, tm, torch.from_numpy(x))
        jy, jaux = j_moe.moe_dense(jcfg, jm, jnp.asarray(x))
        _close(y, jy, what=f"layer {layer} y")
        _close(aux, jaux, what=f"layer {layer} aux")
        xt = x.reshape(-1, cfg.d_model)
        w, ids, probs = moe._router(cfg, tm["router"], torch.from_numpy(xt))
        jw, jids, jprobs = j_moe._router(jcfg, jm["router"], jnp.asarray(xt))
        _close(probs, jprobs, what="router probabilities")
        _close(w, jw, what="router weights")
        # equal ids mean something only if no token sits near a tie
        top = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
        gap = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
        assert gap > 2 * TOL * float(top.max()), f"near tie: gap {gap}"
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        y2, aux2 = moe.moe_forward(cfg.replace(moe_impl="auto"), tm,
                                   torch.from_numpy(x))
        assert torch.equal(y2, y) and torch.equal(aux2, aux)
        # decode and prefill ask for no aux: the same y, and none computed
        y3, aux3 = moe.moe_forward(cfg, tm, torch.from_numpy(x), aux=False)
        assert aux3 is None and torch.equal(y3, y)


def test_moe_aux_loss_balanced_is_one():
    """A uniform router with balanced routing gives aux == 1 (Switch
    normalization; ``test_attention.py``'s twin)."""
    cfg = registry.get_config(PHI, smoke=True)
    e, t = cfg.n_experts, 64
    probs = torch.full((t, e), 1.0 / e)
    ids = torch.stack([torch.arange(t) % e, (torch.arange(t) + 1) % e], 1)
    assert float(moe._aux_loss(cfg, probs, ids)) == pytest.approx(1.0,
                                                                  rel=1e-5)


def test_quantize_kv_bit_for_bit():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 1, 4, 32)) * rng.uniform(
        0.01, 5.0, (3, 1, 4, 1))).astype(np.float32)
    x[0, 0, 1] = 0.0  # an all-zero head: the 1e-6 floor
    x[1, 0, 2, :4] = [1.0, -0.5, 0.25, 127.0]  # halves after the scaling
    codes, scale = attention._quantize_kv(torch.from_numpy(x))
    jcodes, jscale = j_attention._quantize_kv(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(jscale).view(np.int32))


def _jax_pre_rounding(jcfg, jp, jstate, tok):
    """JAX's decode-step body, layer by layer: each layer's k / scale and
    v / scale before the rounding, (L, B, 1, Kv, D) each."""
    pos = jstate["pos"]
    x = j_layers.embed_tokens(jcfg, jp["embed"], tok[:, None])
    positions = jnp.full((tok.shape[0], 1), pos, jnp.int32)
    pre = {"k": [], "v": []}
    for i in range(jcfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        lc = jax.tree_util.tree_map(lambda a: a[i], jstate["cache"])
        h = j_layers.apply_norm(jcfg, lp["ln1"], x)
        _, k, v = j_attention._project_qkv(jcfg, lp["attn"], h, positions)
        for name, a in (("k", k), ("v", v)):
            _, scale = j_attention._quantize_kv(a)
            pre[name].append(np.asarray(a / scale[..., None]))
        out, _ = j_attention.gqa_decode_int8(jcfg, lp["attn"], h, lc, pos)
        x = x + out
        h = j_layers.apply_norm(jcfg, lp["ln2"], x)
        if jcfg.is_moe:
            x = x + j_moe.moe_forward(jcfg, lp["moe"], h)[0]
        else:
            x = x + j_layers.apply_ffn(jcfg, lp["ffn"], h)
    return {k: np.stack(v) for k, v in pre.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_stepwise(arch):
    jcfg, jp, cfg, tp = _params(arch, kv_cache_dtype="int8")
    toks = _tokens(cfg, (S, B), seed=6)
    jstate = j_registry.init_decode_state(jcfg, B, S)
    near_half = flipped = 0
    for i in range(S):
        tstate = {"cache": convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate["cache"]), "cpu"),
            "pos": int(jstate["pos"])}
        pre = _jax_pre_rounding(jcfg, jp, jstate, jnp.asarray(toks[i]))
        got, tstate = registry.decode_step(cfg, tp, tstate,
                                           torch.from_numpy(toks[i]))
        want, jstate = j_registry.decode_step(jcfg, jp, jstate,
                                              jnp.asarray(toks[i]))
        agree = True
        for name in ("k", "v"):
            assert tstate["cache"][name].dtype == torch.int8
            ours = tstate["cache"][name][:, :, i].numpy()
            theirs = np.asarray(jstate["cache"][name])[:, :, i]
            _close(tstate["cache"][f"{name}_scale"][:, :, i],
                   np.asarray(jstate["cache"][f"{name}_scale"])[:, :, i],
                   what=f"step {i} {name} scales")
            p = np.abs(pre[name][:, :, 0])
            close_to_half = np.abs(p - np.floor(p) - 0.5) <= TOL * 127
            near_half += int(close_to_half.sum())
            diff = ours != theirs
            assert not (diff & ~close_to_half).any(), (
                f"step {i} {name}: codes differ away from a half")
            assert (np.abs(ours.astype(int) - theirs) <= 1).all()
            flipped += int(diff.sum())
            agree &= not diff.any()
        if agree:
            _close(got, want, what=f"step {i} logits")
    print(f"{arch}: {near_half} elements within {TOL * 127:.2e} of a half "
          f"before the rounding, {flipped} codes rounded the other way")


@pytest.mark.parametrize("kv,bound", [("native", 5e-3), ("int8", 0.05)])
def test_port_decode_matches_its_forward(f32, kv, bound):
    """``test_archs.py``'s decode-vs-forward bounds, inside the port."""
    _, _, cfg, tp = f32
    cfg = cfg.replace(kv_cache_dtype=kv)
    toks = torch.from_numpy(_tokens(cfg, (B, S), seed=2))
    full, _ = registry.forward(cfg, tp, {"tokens": toks})
    state = registry.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for i in range(S):
        lg, state = registry.decode_step(cfg, tp, state, toks[:, i])
        outs.append(lg)
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < bound, rel
    if kv == "int8":
        assert state["cache"]["k"].dtype == torch.int8
        with pytest.raises(NotImplementedError, match="native"):
            transformer.prefill(cfg, tp, toks, registry.init_decode_state(
                cfg, B, S, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weights_cross_bit_for_bit(arch):
    jcfg, jp, cfg, tp = _params(arch, "bfloat16")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        want = np.asarray(leaf)
        if path[-1].key == "router":  # the router stays f32
            assert node.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(node.numpy(), want)
            continue
        assert node.dtype == torch.bfloat16
        back = convert.params_to_numpy(node)
        assert back.dtype == np.int16
        np.testing.assert_array_equal(back.view(ml_dtypes.bfloat16), want)
    assert ("router" in tp["layers"].get("moe", {})) == cfg.is_moe


@pytest.mark.parametrize("arch", ["qwen2.5-3b", PHI])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--gen", "4"]) == 0
    assert f"{arch} on cpu: 2x4 tokens" in capsys.readouterr().out
