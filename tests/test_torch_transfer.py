"""Port weight-transfer path against the JAX package on the CPU.

* the plain versions of K7-K9 (``kernels/quantize/ref.py``, reached through
  the ``ops`` wrappers on CPU tensors) against the Pallas kernels in
  interpret mode (K7, K8: exact) and against the receiver's numpy decode
  (K9: bit for bit), with weights on the grid's bounds and tie points;
* ``quantization.quantize`` (with and without ``prev``: hysteresis, the
  outlier sidecar, regrids) and the byte format against
  ``repro.core.quantization``;
* layout manifests and bytes (a bfloat16 leaf included);
* ``Sender`` frames byte-identical to ``repro``'s over full -> delta ->
  patch sequences, frames applied across the packages in both directions to
  identical weights;
* the ``FrameError`` taxonomy on truncated, corrupt and stale frames, each
  leaving the receiver untouched, as ``repro``'s receiver does.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import layout as jlayout
from repro.checkpoint import transfer as JT
from repro.common.config import FFMConfig as JFFMConfig
from repro.core import deepffm as jdeepffm
from repro.core import quantization as JQ
from repro.kernels.quantize.quantize import (dequantize_pallas, minmax,
                                             quantize_pallas)
from repro_torch.checkpoint import layout, transfer as T
from repro_torch.common.config import FFMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as Q
from repro_torch.kernels.quantize import ops as qops

CFG = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                mlp_hidden=(16, 8))
JCFG = JFFMConfig(**CFG.__dict__)


def _weights(n: int, seed: int) -> np.ndarray:
    """Normal weights with some placed exactly on the rounded grid's bounds
    and on code tie points (half a bucket above a code)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(0, 0.3, n)).astype(np.float32)
    w_min, _, bucket = JQ.compute_bounds(jnp.asarray(w))
    lo, b = np.float32(w_min), np.float32(bucket)
    k = rng.integers(0, 60000, 8).astype(np.float32)
    special = np.concatenate([[lo, lo + b, np.float32(w.max())],
                              lo + (k + np.float32(0.5)) * b, lo + k * b])
    w[rng.choice(n, min(n, special.size), replace=False)] = special[:n]
    return w


@pytest.mark.parametrize("n", [17, 128, 1000, 8192, 100_001])
def test_wire_kernels_plain_versions_match_pallas_and_numpy(n):
    w = _weights(n, n)
    tw = torch.from_numpy(w)
    mn, mx = minmax(jnp.asarray(w))
    got = qops.minmax(tw)
    assert got.dtype == torch.float32
    assert got.tolist() == [float(mn), float(mx)]

    w_min, _, bucket = JQ.compute_bounds(jnp.asarray(w))
    q_jax = np.asarray(quantize_pallas(jnp.asarray(w), jnp.float32(w_min),
                                       jnp.float32(bucket)))
    q = qops.quantize_codes(tw, w_min, bucket)
    assert q.dtype == torch.int16
    np.testing.assert_array_equal(q.numpy().view(np.uint16), q_jax)
    np.testing.assert_array_equal(
        q.numpy().view(np.uint16), np.asarray(JQ._quantize_core(
            jnp.asarray(w), jnp.float32(w_min), jnp.float32(bucket))))

    # K9 is held to the receiver's numpy decode bit for bit; the Pallas
    # kernel may differ there in the last bit (fma vs mul+add)
    buf = JQ.to_bytes(q_jax.astype(np.uint16), JQ.QuantMeta(w_min, bucket, n))
    d = qops.dequantize_codes(q, w_min, bucket)
    np.testing.assert_array_equal(d.numpy(), JQ.dequantize_from_bytes(buf))
    np.testing.assert_allclose(
        d.numpy(), np.asarray(dequantize_pallas(
            jnp.asarray(q_jax), jnp.float32(w_min), jnp.float32(bucket))),
        rtol=1e-6, atol=1e-6)


def test_minmax_propagates_nan_and_rejects_empty():
    w = torch.tensor([0.5, float("nan"), -2.0])
    assert torch.isnan(qops.minmax(w)).all()
    assert np.isnan(float(jnp.min(jnp.asarray(w.numpy()))))
    with pytest.raises(ValueError):
        qops.minmax(torch.zeros(0))


def _jq(w, prev):
    jprev = None if prev is None else JQ.QuantMeta(*prev.__dict__.values())
    return JQ.quantize(jnp.asarray(w), prev=jprev)


@pytest.mark.parametrize("case", ["fresh", "inside", "outliers_on_bounds",
                                  "too_many_outliers", "shrunk"])
def test_quantize_matches_reference(case):
    rng = np.random.default_rng(5)
    w0 = rng.normal(0, 0.3, 20_000).astype(np.float32)
    _, prev, _ = Q.quantize(torch.from_numpy(w0))
    lo = prev.w_min
    hi = prev.w_min + prev.bucket_size * (Q.B_MAX - 1)
    w = (w0 + rng.normal(0, 1e-3, w0.size)).astype(np.float32)
    w = np.clip(w, np.float32(lo), np.float32(hi))
    if case == "fresh":
        prev = None
    elif case == "outliers_on_bounds":
        # exactly on the f32 bounds (inside), one ulp beyond (outliers)
        f_lo, f_hi = np.float32(lo), np.float32(hi)
        w[:4] = [f_lo, f_hi, np.nextafter(f_lo, np.float32(-np.inf)),
                 np.nextafter(f_hi, np.float32(np.inf))]
        w[4:9] = f_hi + np.float32(0.5)
    elif case == "too_many_outliers":
        w[:100] = np.float32(hi) + np.float32(0.25)
    elif case == "shrunk":
        w = (w * np.float32(0.1)).astype(np.float32)
    q, meta, (idx, vals) = Q.quantize(torch.from_numpy(w), prev=prev)
    jq, jmeta, (jidx, jvals) = _jq(w, prev)
    assert meta.__dict__ == jmeta.__dict__
    np.testing.assert_array_equal(q.numpy().view(np.uint16), np.asarray(jq))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)
    assert idx.dtype == np.uint64 and vals.dtype == np.float32
    if case == "outliers_on_bounds":
        assert list(idx) == [2, 3, 4, 5, 6, 7, 8]
    if case in ("too_many_outliers", "shrunk"):
        assert meta.bucket_size != prev.bucket_size  # regrid
    # the byte format and both decodes
    buf = Q.to_bytes(q, meta, (idx, vals))
    assert buf == JQ.to_bytes(jq, jmeta, (jidx, jvals))
    assert buf == Q.quantize_to_bytes(torch.from_numpy(w), prev=prev)
    want = JQ.dequantize_from_bytes(buf)
    np.testing.assert_array_equal(Q.dequantize_from_bytes(buf), want)
    np.testing.assert_array_equal(
        Q.dequantize(q, meta, (idx, vals)).numpy(), want)
    assert Q.max_error(meta) == JQ.max_error(jmeta)


def test_bounds_match_reference():
    rng = np.random.default_rng(9)
    w = rng.normal(0.05, 0.2, 3000).astype(np.float32)
    assert Q.compute_bounds(torch.from_numpy(w)) == \
        JQ.compute_bounds(jnp.asarray(w))
    _, prev, _ = JQ.quantize(jnp.asarray(w))
    for w2 in (w * np.float32(0.9), w * np.float32(1.5), w * np.float32(0.1)):
        assert Q.stable_bounds(torch.from_numpy(w2), Q.QuantMeta(
            *prev.__dict__.values())) == JQ.stable_bounds(jnp.asarray(w2), prev)


def _np_tree(model="deepffm", seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jdeepffm.init_params(JCFG, jax.random.PRNGKey(seed), model))
    rng = np.random.default_rng(seed + 1)
    params["lr"]["w"] = rng.normal(0, 0.1, CFG.hash_space).astype(np.float32)
    return params


def test_layout_matches_reference_with_bf16_leaf():
    tree = _np_tree()
    rng = np.random.default_rng(2)
    tree["extra"] = {"h": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
                     "i": np.arange(4, dtype=np.int32)}
    ttree = params_from_numpy({k: v for k, v in tree.items() if k != "extra"},
                              "cpu")
    ttree["extra"] = {
        "h": torch.from_numpy(tree["extra"]["h"].view(np.int16).copy()).view(
            torch.bfloat16),
        "i": torch.arange(4, dtype=torch.int32)}
    assert layout.manifest_of(ttree) == jlayout.manifest_of(tree)
    buf, manifest = layout.to_bytes(ttree)
    jbuf, jmanifest = jlayout.to_bytes(tree)
    assert buf == jbuf and manifest == jmanifest
    assert [e["dtype"] for e in manifest if e["path"].startswith("extra")] \
        == ["bfloat16", "int32"]
    back = layout.from_bytes(jbuf, jmanifest, like=ttree, device="cpu")
    assert torch.equal(back["extra"]["h"], ttree["extra"]["h"])
    assert torch.equal(back["ffm"]["emb"], ttree["ffm"]["emb"])


def _round_params(seed=0):
    """Three rounds of weights: a start, a sparse update (1% of rows, every
    dense leaf) and a dense one."""
    rng = np.random.default_rng(seed + 10)
    p1 = _np_tree(seed=seed)
    p2 = jax.tree_util.tree_map(np.array, p1)
    rows = np.sort(rng.choice(CFG.hash_space, 12, replace=False))
    emb = p2["ffm"]["emb"]
    emb[rows] += rng.normal(0, 2e-3, emb[rows].shape).astype(np.float32)
    p2["lr"]["w"][rows] += np.float32(1e-3)
    for k in p2["mlp"]:
        p2["mlp"][k] = p2["mlp"][k] + np.float32(1e-3)
    p3 = jax.tree_util.tree_map(np.array, p2)
    p3["ffm"]["emb"] += rng.normal(0, 1e-3, emb.shape).astype(np.float32)
    return [(p1, None), (p2, {"ffm/emb": rows, "lr/w": rows}), (p3, None)]


@pytest.mark.parametrize("mode", T.MODES)
def test_sender_frames_byte_identical_and_cross_apply(mode):
    jsnd, snd = JT.Sender(mode=mode), T.Sender(mode=mode, device="cpu")
    jrcv, rcv = JT.Receiver(), T.Receiver(device="cpu")
    kinds = []
    for params, touched in _round_params():
        jframe = jsnd.make_update(params, touched=touched)
        frame = snd.make_update(params_from_numpy(params, "cpu"),
                                touched=touched)
        assert frame == jframe
        kinds.append(JT.unframe(frame).kind)
        assert snd.manifest == jsnd.manifest
        # each package's receiver applies the other's frames
        jrcv.apply_update(frame)
        rcv.apply_update(jframe)
        jgot = jrcv.materialize(manifest=snd.manifest, like=params)
        got = rcv.materialize(manifest=jsnd.manifest,
                              like=params_from_numpy(params, "cpu"))
        for key in ("ffm", "lr", "mlp", "norm"):
            for leaf in params.get(key, {}):
                np.testing.assert_array_equal(got[key][leaf].numpy(),
                                              np.asarray(jgot[key][leaf]))
        assert rcv.version == jrcv.version
        assert rcv.last_touched_elems == jrcv.last_touched_elems
    patchy = "patch" in mode
    assert kinds == [T.KIND_FULL, T.KIND_DELTA,
                     T.KIND_PATCH if patchy else T.KIND_FULL]
    assert snd.resync_frame() == jsnd.resync_frame()


def test_receiver_keeps_delta_chain_across_materialize_gaps():
    """Two deltas between materializations union their ranges; the
    incremental decode equals a full decode of the same bytes."""
    seq = _round_params(seed=3)
    p1, _ = seq[0]
    snd, rcv = T.Sender(device="cpu"), T.Receiver(device="cpu")
    rcv.apply_update(snd.make_update(params_from_numpy(p1, "cpu")))
    rcv.materialize(manifest=snd.manifest)
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(np.array, p1)
    for _ in range(2):
        rows = rng.choice(CFG.hash_space, 5, replace=False)
        p["ffm"]["emb"][rows] += np.float32(1e-3)
        rcv.apply_update(snd.make_update(params_from_numpy(p, "cpu"),
                                         touched={"ffm/emb": rows}))
    got = rcv.materialize(manifest=snd.manifest)
    assert rcv.last_touched_elems is not None
    full = T.Receiver(device="cpu")
    full.apply_update(snd.resync_frame())
    want = full.materialize(manifest=snd.manifest)
    for k in want:
        assert torch.equal(got[k], want[k])


def _mangle(kind, frames):
    full, delta = frames
    if kind == "truncated_header":
        return delta[:5]
    if kind == "truncated_body":
        return delta[:-7]
    if kind == "bitflip":
        b = bytearray(delta)
        b[len(b) // 2] ^= 0x10
        return bytes(b)
    if kind == "bad_magic":
        return b"\x00" + delta[1:]
    if kind == "replayed_delta":
        return delta  # applied twice: chains from the version before
    if kind == "stale_full":
        return full


@pytest.mark.parametrize("kind", ["truncated_header", "truncated_body",
                                  "bitflip", "bad_magic", "replayed_delta",
                                  "stale_full"])
def test_frame_errors_match_reference_and_leave_receiver_untouched(kind):
    seq = _round_params(seed=1)
    snd = T.Sender(device="cpu")
    full = snd.make_update(params_from_numpy(seq[0][0], "cpu"))
    delta = snd.make_update(params_from_numpy(seq[1][0], "cpu"),
                            touched=seq[1][1])
    rcv, jrcv = T.Receiver(device="cpu"), JT.Receiver()
    for r in (rcv, jrcv):
        r.apply_update(full)
    if kind in ("replayed_delta", "stale_full"):
        for r in (rcv, jrcv):
            r.apply_update(delta)
    before = (rcv._current, rcv._sidecar, rcv.version, rcv.mode)
    bad = _mangle(kind, (full, delta))
    with pytest.raises(JT.FrameError) as jerr:
        jrcv.apply_update(bad)
    with pytest.raises(T.FrameError) as err:
        rcv.apply_update(bad)
    assert type(err.value).__name__ == type(jerr.value).__name__
    assert (rcv._current, rcv._sidecar, rcv.version, rcv.mode) == before
    # the NACK answer lands on the untouched state
    rcv.apply_update(snd.resync_frame())
    assert rcv.version == snd.version


def test_layout_mismatch_delta_is_rejected():
    snd = T.Sender(mode="raw", device="cpu")
    p = params_from_numpy(_np_tree(), "cpu")
    snd.make_update(p)
    delta = snd.make_update(p, touched={"ffm/emb": np.asarray([3])})
    small = T.Sender(mode="raw", device="cpu")
    rcv = T.Receiver(device="cpu")
    rcv.apply_update(small.make_update({"x": torch.zeros(4)}))
    rcv.version = T.unframe(delta).base_version
    with pytest.raises(T.LayoutMismatchError):
        rcv.apply_update(delta)


def test_quantized_nbytes_matches_reference():
    params = _np_tree()
    want = JQ.quantized_nbytes(JQ.quantize_params_rows(params))
    got = Q.quantized_nbytes(Q.quantize_params_rows(
        params_from_numpy(params, "cpu")))
    assert got == want
