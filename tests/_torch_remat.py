"""Shared checks of the port's rematerialization (``models/remat.py``)
against the JAX package's ``jax.checkpoint`` on the CPU
(``tests/test_torch_remat_parity.py`` and
``tests/test_torch_remat_parity_families.py`` run them per arch id).

The saved set: each family's checkpointed body is built from the JAX
package's functions as its ``forward`` builds it (transformer: one
``_layer_fwd``; encdec: the encoder's and the decoder's layer, the cross
keys and values inside; ssm: one block; hybrid: one super-block, the
shared weights and ``x0`` coming in from outside) and wrapped in
``jax.checkpoint`` with the config's policy. ``saved_residuals`` lists what
its backward keeps; the entries "from the argument" (the body's inputs)
are dropped, leaving the products the policy saves. The port's side is
what each region of a ``steps.loss_and_grads`` call keeps (``remat._Forward``
at the region's end). The two are compared per region as multisets of
(element count, dtype): an ``mm`` keeps its 2-d (tokens, features) output
where JAX keeps the einsum's (B, S, H, K), and JAX keeps a few products
as the output of the jitted elementwise function that reads them
(``silu`` of the gate, the padded v of MLA), of the same size in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax._src.ad_checkpoint import saved_residuals

from repro.models import attention as j_attention
from repro.models import encdec as j_encdec
from repro.models import hybrid as j_hybrid
from repro.models import layers as j_layers
from repro.models import ssm as j_ssm
from repro.models import transformer as j_transformer
from repro_torch.models import remat
from repro_torch.train import steps
from tests import _torch_llm_train as T


def _policy(cfg):
    return (None if cfg.remat_policy == "nothing"
            else jax.checkpoint_policies.dots_with_no_batch_dims_saveable)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _jax_saved(body, cfg, *args):
    """The multiset of (element count, dtype) that ``jax.checkpoint(body)``
    saves for its backward, its arguments left out."""
    fn = jax.checkpoint(body, policy=_policy(cfg))

    def total(*a):
        leaves = jax.tree_util.tree_leaves(fn(*a))
        return sum(jnp.sum(t) for t in leaves)

    return sorted((int(np.prod(a.shape)), a.dtype.name)
                  for a, src in saved_residuals(total, *args)
                  if "from the argument" not in src)


def jax_regions(cfg, jp, n_tokens):
    """Each region's saved multiset in the order the port's forward runs
    its regions."""
    b, s = n_tokens
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(b, s, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        def enc_body(x, lp):
            h = j_layers.apply_norm(cfg, lp["ln1"], x)
            q, k, v = (jnp.einsum("bsd,dhk->bshk", h, lp["attn"][w])
                       for w in ("wq", "wk", "wv"))
            o = j_attention.flash_attention(q, k, v, causal=False)
            x = x + jnp.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
            return x + j_layers.apply_ffn(
                cfg, lp["ffn"], j_layers.apply_norm(cfg, lp["ln2"], x))

        def dec_body(x, enc_out, lp):
            h = j_layers.apply_norm(cfg, lp["ln1"], x)
            x = x + j_attention.gqa_forward(cfg, lp["self_attn"], h)
            h = j_layers.apply_norm(cfg, lp["ln_x"], x)
            k, v = j_encdec._cross_kv(lp["cross"], enc_out)
            x = x + j_encdec._cross_attend(cfg, lp["cross"], h, k, v)
            return x + j_layers.apply_ffn(
                cfg, lp["ffn"], j_layers.apply_norm(cfg, lp["ln2"], x))

        return ([_jax_saved(enc_body, cfg, x, _layer(jp["enc_layers"], i))
                 for i in range(cfg.n_enc_layers)]
                + [_jax_saved(dec_body, cfg, x, 0.5 * x,
                              _layer(jp["dec_layers"], i))
                   for i in range(cfg.n_layers)])
    if cfg.family == "ssm":
        def block(x, lp):
            return x + j_ssm.mamba_forward(
                cfg, lp["mixer"], j_layers.apply_norm(cfg, lp["ln"], x))

        return [_jax_saved(block, cfg, x, _layer(jp["layers"], i))
                for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        def attn_fn(sp, h):
            return j_attention.gqa_forward(cfg, sp["attn"], h)

        def super_body(x, x0, shared, lp, lora):
            for j in range(cfg.attn_period - 1):
                x = j_hybrid._mamba_block(cfg, _layer(lp, j), x)
            return j_hybrid._shared_block(cfg, shared, lora, x, x0, attn_fn)

        return [_jax_saved(super_body, cfg, x, 0.5 * x, jp["shared"],
                           _layer(jp["mamba"], i), _layer(jp["lora"], i))
                for i in range(j_hybrid._n_super(cfg))]

    def layer(x, lp):
        return j_transformer._layer_fwd(cfg, lp, x, None, 0)

    return [_jax_saved(layer, cfg, x, _layer(jp["layers"], i))
            for i in range(cfg.n_layers)]


def port_regions(cfg, tp, batch, monkeypatch):
    """Each dots region's kept multiset, in the order the forward of one
    ``steps.loss_and_grads`` call ran them."""
    regions = []
    exit_ = remat._Forward.__exit__

    def recording(self, *exc):
        out = exit_(self, *exc)
        regions.append(sorted((t.numel(), str(t.dtype).split(".")[-1])
                              for t in self.region.kept))
        return out

    monkeypatch.setattr(remat._Forward, "__exit__", recording)
    steps.loss_and_grads(cfg, tp, batch)
    return regions


def check_saved_set(arch, policy, monkeypatch):
    """The products each region of the port keeps equal those JAX's
    checkpointed body saves (``"nothing"``: none on either side)."""
    jcfg, jp, cfg, tp, batch = T.setup(arch, remat=True,
                                       remat_policy=policy)
    want = jax_regions(jcfg, jp, batch["tokens"].shape)
    got = port_regions(cfg, tp, T._torch_batch(batch), monkeypatch)
    if policy == "nothing":
        assert got == [] and all(r == [] for r in want), want
        return
    assert got == want and all(got)
