"""The port's flash attention against the JAX package on the CPU.

On CPU tensors ``kernels/flash_attention/ops.py`` runs its plain version
(``ref.py``); both are held, on ``test_kernels.py``'s sweep (B = 2; causal,
sliding-window and unmasked; GQA 1:1, 2:1 and 4:1; D 16 / 32 / 64; f32 and
bf16) and on the shapes that hit the edges of the bf16 kernel's 128 x 128
tiles (the main path's 32 / 8 heads with S ragged to 64 and 128, cut to
S = 200 and B = 1 for interpret mode; D = 128 ragged; S below one tile; a
window whose first live tile is wholly masked for some rows; D = 112,
zamba2's head dim, ragged and windowed; MLA's qk / v head dims 48 / 32
and 192 / 128, causal, ragged, windowed and unmasked) and on
``CROSS``, queries and keys of different lengths (Sq = 1, Sq < Sk and
Sq > Sk, causal with the mask aligned at position 0 and unmasked, D 32,
64 and 112, and the MLA pairs: the encoder-decoder's cross-attention and
its decode), against three JAX functions on the same seeded inputs: the
JAX ``ref.py``, ``flash_attention_pallas`` in interpret mode with 32-row
blocks, and the models' jnp flash (``repro.models.attention.
flash_attention``) with 32-row chunks. The JAX functions take one head dim
for q, k and v: for an MLA pair they get v zero-padded to the qk dim and
their output is sliced back to v's, as ``repro.models.attention.
mla_forward`` does; the port takes v at its own width. Tolerances are the
reference's own (``test_kernels.py``): 2e-5 for f32, 3e-2 for bf16.
``test_attention.py::test_flash_noncausal`` has a twin on its own inputs.
The wrapper's checks (the (qk, v) head-dim pairs and dtypes each kernel
body takes, TMA's 16-byte alignment) and its launch count (none on CPU
tensors) are tested too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models.attention import flash_attention as j_model_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention

def _params(cases, d_at, ids):
    """pytest params of ``cases`` (7 entries, D at ``d_at``) with v's head
    dim appended: D's own for a square case (its id unchanged), an MLA
    case's 8th entry (its id then ends in ``-v<Dv>``)."""
    out = []
    for c in cases:
        head, dv = c[:7], (c[7] if len(c) > 7 else c[d_at])
        out.append(pytest.param(*head, dv, id=ids(head) + (
            f"-v{dv}" if len(c) > 7 else "")))
    return out


def _sweep_id(c):
    return ("-".join(map(str, c[1:])) if c[0] == 2 else
            f"B{c[0]}-" + "-".join(map(str, c[1:])))


# (B, S, H, Kv, D, causal, window[, Dv]); test_kernels.py's four keep their
# ids; then MLA's (qk, v) pairs of deepseek-v2's smoke and full configs
SWEEP = _params([
    (2, 64, 4, 4, 16, True, 0), (2, 100, 8, 2, 32, True, 0),
    (2, 128, 4, 4, 16, True, 48), (2, 96, 4, 2, 64, False, 0),
    (1, 200, 32, 8, 64, True, 0), (2, 300, 8, 2, 128, True, 0),
    (2, 40, 4, 4, 64, True, 0), (2, 257, 4, 1, 32, True, 100),
    (1, 130, 4, 4, 112, True, 0), (2, 70, 4, 2, 112, True, 33),
    (2, 70, 4, 4, 48, True, 0, 32), (2, 96, 4, 2, 48, False, 0, 32),
    (2, 100, 4, 4, 48, True, 33, 32), (1, 130, 4, 4, 192, True, 0, 128),
    (2, 70, 4, 1, 192, False, 0, 128)], 4, _sweep_id)


# (B, Sq, Sk, H, Kv, D, causal[, Dv]): Sq = 1 (a decode step's
# cross-attention, and causal, where a row sees key 0 only), Sq < Sk and
# Sq > Sk across several 32-row blocks, seamless' smoke shapes (4 heads of
# 32), D = 112 (zamba2-7b's head dim, between the power-of-two instances),
# and MLA's pairs
CROSS = _params([
    (2, 1, 40, 4, 4, 32, False), (2, 1, 40, 4, 2, 64, True),
    (2, 24, 70, 4, 4, 64, False), (2, 24, 70, 8, 2, 32, True),
    (2, 70, 24, 4, 4, 32, False), (2, 70, 24, 4, 1, 64, True),
    (2, 16, 12, 4, 4, 32, False), (2, 1, 12, 4, 4, 32, False),
    (2, 24, 70, 4, 4, 112, False), (2, 1, 40, 4, 2, 112, True),
    (2, 24, 70, 4, 4, 48, False, 32), (2, 1, 40, 4, 4, 192, True, 128),
    (2, 70, 24, 4, 4, 192, True, 128), (2, 24, 70, 4, 2, 192, False, 128)],
    5, lambda c: "-".join(map(str, c)))


def _qkv(s, h, kv, d, seed, b=2, sk=None, dv=None):
    """q (b, s, h, d), k (b, sk, kv, d) and v (b, sk, kv, dv); sk = s and
    dv = d unless given."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    dv = d if dv is None else dv
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dv)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,Kv,D,causal,window,Dv", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(B, S, H, Kv, D, causal, window, Dv,
                                     dtype):
    _check_against_jax(_qkv(S, H, Kv, D, S + H, b=B, dv=Dv), dtype, causal,
                       window)


@pytest.mark.parametrize("B,Sq,Sk,H,Kv,D,causal,Dv", CROSS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sq_ne_sk_matches_jax(B, Sq, Sk, H, Kv, D, causal,
                                              Dv, dtype):
    _check_against_jax(_qkv(Sq, H, Kv, D, Sq + 7 * Sk, b=B, sk=Sk, dv=Dv),
                       dtype, causal, 0)


def test_flash_noncausal():
    """``test_attention.py::test_flash_noncausal``'s inputs and tolerance:
    the port against JAX's naive oracle (``ref.py``) and its model flash
    with 16-row chunks."""
    q = jax.random.normal(jax.random.PRNGKey(0), (1, 40, 4, 16))
    k = jax.random.normal(jax.random.PRNGKey(1), (1, 40, 4, 16))
    v = jax.random.normal(jax.random.PRNGKey(2), (1, 40, 4, 16))
    tq, tk, tv = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    got = attention.flash_attention(tq, tk, tv, causal=False).numpy()
    for want in (j_ref(q, k, v, causal=False),
                 j_model_flash(q, k, v, causal=False, chunk_q=16,
                               chunk_k=16)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    # unmasked: a late key reaches the first query (the causal mask would
    # hide it)
    causal = attention.flash_attention(tq, tk, tv, causal=True).numpy()
    assert not np.allclose(got[:, 0], causal[:, 0], atol=1e-3)


def _check_against_jax(arrs, dtype, causal, window):
    """The port's ref.py, ops.py and models.attention against the JAX ref,
    the Pallas kernel in interpret mode and the models' jnp flash (v
    zero-padded to the qk dim on the JAX side, their output sliced back to
    v's)."""
    d, dv = arrs[0].shape[-1], arrs[2].shape[-1]
    vpad = np.pad(arrs[2], ((0, 0), (0, 0), (0, 0), (0, d - dv)))
    jq, jk, jv = (jnp.asarray(a).astype(dtype)
                  for a in (arrs[0], arrs[1], vpad))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    before = dict(_build.launches)
    ours = {
        "ref.py": ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                          window=window),
        "ops.py": ops.flash_attention(tq, tk, tv, causal=causal,
                                      window=window),
        "models.attention": attention.flash_attention(
            tq, tk, tv, causal=causal, window=window),
    }
    assert _build.launches == before  # CPU tensors: the plain version
    theirs = {
        "ref": j_ref(jq, jk, jv, causal=causal, window=window),
        "pallas": flash_attention_pallas(jq, jk, jv, causal=causal,
                                         window=window, block_q=32,
                                         block_k=32),
        "model flash": j_model_flash(jq, jk, jv, causal=causal, window=window,
                                     chunk_q=32, chunk_k=32),
    }
    tol = 2e-5 if dtype == "float32" else 3e-2
    for name, got in ours.items():
        assert (got.dtype == tq.dtype
                and got.shape == tq.shape[:3] + (dv,)), name
        for jname, want in theirs.items():
            want = np.asarray(want, np.float32)
            assert not want[..., dv:].any()  # v's zero columns stay zero
            np.testing.assert_allclose(
                got.float().numpy(), want[..., :dv], rtol=tol, atol=tol,
                err_msg=f"port {name} vs JAX {jname}")


@pytest.mark.parametrize("bad", ["head_dim", "dtype_mix", "gqa", "shape",
                                 "int", "window", "v_narrower",
                                 "unlisted_pair"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 2, 16, 0))
    if bad == "head_dim":  # square 48 is not an instance (48 takes v 32)
        q, k, v = (torch.zeros(*t.shape[:3], 48) for t in (q, k, v))
    elif bad == "v_narrower":  # D = 64 is square-only
        q, k = (torch.zeros(*t.shape[:3], 64) for t in (q, k))
        v = torch.zeros(*v.shape[:3], 32)
    elif bad == "unlisted_pair":  # 192 takes v 128 only
        q, k = (torch.zeros(*t.shape[:3], 192) for t in (q, k))
        v = torch.zeros(*v.shape[:3], 64)
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "gqa":  # 4 query heads over 3 kv heads
        k = v = torch.zeros(2, 8, 3, 16)
    elif bad == "shape":
        v = v[:, :4]
    elif bad == "int":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=-1 if bad == "window" else 0)


def test_flash_attention_head_dims_are_the_kernels():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    launcher = {"wgmma": "launch_wgmma", "cuda-core": "launch_f32"}
    assert {body for body, _ in ops.BODIES.values()} == set(launcher)
    for body, pairs in ops.BODIES.values():
        for d, dv in pairs:
            assert (f"case pair({d}, {dv}): return {launcher[body]}<{d}, "
                    f"{dv}>(") in src
        assert src.count(f"return {launcher[body]}<") == len(pairs)


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 112, 128, 256, 192,
                               (48, 32), (192, 128), (128, 64), (32, 48)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_body_per_dtype_and_head_dim(dtype, d):
    """``d`` is the qk head dim of a square case, or a (qk, v) pair."""
    dtype = getattr(torch, dtype)
    d, dv = d if isinstance(d, tuple) else (d, d)
    want = {torch.bfloat16: "wgmma", torch.float32: "cuda-core"}.get(dtype)
    if want is None or (d, dv) not in ops.BODIES[dtype][1]:
        with pytest.raises(ValueError):
            ops.kernel_body(dtype, d, dv)
        q = torch.zeros(1, 4, 2, d, dtype=dtype)
        v = torch.zeros(1, 4, 1, dv, dtype=dtype)
        with pytest.raises(ValueError):  # the wrapper asks the same helper
            ops.flash_attention(q, q[:, :, :1], v)
    else:
        assert ops.kernel_body(dtype, d, dv) == want


@pytest.mark.parametrize("offset", [0, 2, 8, 16, 32])
def test_flash_attention_tma_alignment(offset):
    base = 0x7f0000001000
    if offset % 16:
        with pytest.raises(ValueError, match="16-byte"):
            ops.check_tma_alignment(q=base, k=base + offset, v=base)
    else:
        ops.check_tma_alignment(q=base, k=base + offset, v=base + 2 * offset)
