"""Serve an LLM with batched requests and the paper's techniques applied
(the port's twin of ``examples/serve_llm.py``).

Three of the paper's tricks, generalized to the LLM architectures: (1)
weights arrive through the quantized patch channel (§6: ``Sender(mode=
"patch+quant")`` on the trainer's tree, ``Receiver.materialize`` on the
server); (2) the prompt prefix shared by every request is decoded once at
batch 1 and its decode state fanned out to the batch (the context-caching
insight of §5); (3) the batch continues greedily from that state. Both
routes are timed: the shared one, and each request decoding the prefix
alone; the second also checks the first token for token. Run with::

    PYTHONPATH=src python -m repro_torch.serve_llm --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.serve_llm --arch zamba2-7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.serve_llm      # full config, the card

Unlike the JAX example, the fan-out repeats each leaf of the decode state
along its own batch axis, found from the state's layout (the one axis in
which the states for batch 1 and batch 2 differ), so it holds for every
family: zamba2's mamba states are stacked ``(n_super, P-1, B, ...)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import torch

from repro_torch.checkpoint import layout, transfer
from repro_torch.common.device import (DeviceLike, resolve_device,
                                       synchronize)
from repro_torch.models import registry
from repro_torch.train.steps import make_serve_step

# a token of the shared route may differ from the same request decoded alone
# only where the alone route's top-2 logit gap is within twice this share of
# the step's largest |logit| (each route's logits within it of exact ones):
# batch 1 and batch B may take different GEMM kernels. f32: the LLM parity
# tests' tolerance; bf16: the reference's bf16 logit tolerance
GAP_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def batch_axes(cfg, device: DeviceLike = None):
    """The decode state's tree with each tensor leaf's batch axis (``None``
    for leaves without one, and for the position counter): the one axis in
    which the states for batch 1 and batch 2 differ."""
    dev = resolve_device(device)
    one = registry.init_decode_state(cfg, 1, 1, device=dev)
    two = registry.init_decode_state(cfg, 2, 1, device=dev)

    def axis(a, b):
        if not isinstance(a, torch.Tensor):
            return None
        diff = [i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n]
        if len(diff) > 1:
            raise ValueError(f"decode-state leaf {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}: more than one batch axis")
        return diff[0] if diff else None

    return _map(axis, one, two)


def fan_out(state, axes, n: int):
    """A batch-1 decode state -> the same state for ``n`` requests: each
    leaf repeated along its batch axis into fresh memory (the caches are
    written in place, so the rows must not share a buffer). Leaves without
    a batch axis are copied; the position counter is carried over."""

    def rep(a, ax):
        if not isinstance(a, torch.Tensor):
            return a
        if ax is None:
            return a.clone()
        if a.shape[ax] != 1:
            raise ValueError(f"fan_out takes a batch-1 state, got "
                             f"{tuple(a.shape)} at axis {ax}")
        return torch.cat([a] * n, dim=ax)

    return _map(rep, state, axes)


def receive_weights(trainer_params, device: DeviceLike = None):
    """Trainer -> server over the quantized patch channel. Returns
    ``(served params, frame, seconds)``: one ``make_update`` (K7 and K8 on
    the card), ``apply_update`` (the frame's CRC and copies on the host) and
    one decode (K9) into the trainer's structure and dtypes; ``seconds``
    times each of the three (the card synchronized before every clock
    read)."""
    dev = resolve_device(device)
    snd = transfer.Sender(mode="patch+quant", device=dev)
    rcv = transfer.Receiver(device=dev)
    seconds = {}

    def timed(stage, fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        seconds[stage] = time.perf_counter() - t0
        return out

    frame = timed("make_update", lambda: snd.make_update(trainer_params))
    timed("apply_update", lambda: rcv.apply_update(frame))
    params = timed("materialize", lambda: rcv.materialize(
        snd.manifest, like=trainer_params))
    return params, frame, seconds


def decode_prefix(cfg, params, prefix: torch.Tensor, max_len: int,
                  device: DeviceLike = None):
    """The shared prefix decoded one token a step at batch 1 through the
    serve step; returns its decode state."""
    serve = make_serve_step(cfg)
    state = registry.init_decode_state(cfg, 1, max_len,
                                       device=resolve_device(device))
    for i in range(prefix.shape[0]):
        _, state = serve(params, state, prefix[i:i + 1])
    return state


def continue_batch(cfg, params, state, first: torch.Tensor,
                   gen_len: int) -> torch.Tensor:
    """``gen_len`` greedy steps from ``first`` (B,) -> tokens (B, 1 +
    gen_len), ``first`` leading."""
    serve = make_serve_step(cfg)
    toks, outs = first, [first]
    for _ in range(gen_len):
        toks, state = serve(params, state, toks)
        outs.append(toks)
    return torch.stack(outs, 1)


def decode_alone(cfg, params, prefix: torch.Tensor, first: torch.Tensor,
                 gen_len: int, max_len: int):
    """One request on its own at batch 1: the prefix, then ``gen_len``
    greedy steps from ``first`` (1,). Returns tokens (1 + gen_len,) and, per
    step, the top-2 logit gap and the largest |logit| (device tensors)."""
    state = decode_prefix(cfg, params, prefix, max_len, first.device)
    toks, outs, gaps, scales = first, [first], [], []
    for _ in range(gen_len):
        logits, state = registry.decode_step(cfg, params, state, toks)
        lg = logits[0].float()
        top2 = torch.topk(lg, 2).values
        gaps.append(top2[0] - top2[1])
        scales.append(lg.abs().max())
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(toks)
    return torch.cat(outs), torch.stack(gaps), torch.stack(scales)


def check_flips(cfg, shared, alone, gaps, scales) -> Dict[str, Any]:
    """Each request's tokens on the shared route against the same request
    decoded alone. Up to a row's first difference the tokens must agree; a
    difference (a flip) is allowed only where the alone route's top-2 gap
    at that step is within ``2 * GAP_TOL * max |logit|``, else it raises.
    Returns the smallest gap and the flips."""
    tol = GAP_TOL[cfg.dtype]
    flips: List[Dict[str, float]] = []
    for b in range(shared.shape[0]):
        diff = (shared[b] != alone[b]).nonzero()
        if diff.numel():
            t = int(diff[0])  # token t came from step t - 1
            gap, limit = float(gaps[b, t - 1]), 2 * tol * float(scales[b, t - 1])
            flips.append({"request": b, "step": t - 1, "gap": gap,
                          "limit": limit})
            if gap > limit:
                raise RuntimeError(
                    f"request {b}: token {t} of the shared route differs "
                    f"from the request decoded alone at a top-2 gap of "
                    f"{gap:.3e} (allowed: {limit:.3e})")
    return {"min_gap": float(gaps.min()) if gaps.numel() else float("inf"),
            "flips": flips}


def run(cfg, trainer_params, prefix: torch.Tensor, first: torch.Tensor,
        gen_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """The example on given trainer weights, prefix (P,) and first tokens
    (B,). Returns the frame's and the trainer tree's bytes, the served
    params, the shared route's tokens (B, 1 + gen_len), the requests
    decoded alone, the smallest top-2 gap and the flips, and the seconds of
    the transfer's stages and of each route (the card synchronized before
    every clock read)."""
    dev = resolve_device(device)
    prefix, first = prefix.to(dev, torch.int32), first.to(dev, torch.int32)
    b, p = first.shape[0], prefix.shape[0]
    total = p + gen_len + 1
    arch = cfg.arch_id

    params, frame, transfer_s = receive_weights(trainer_params, dev)
    frame_bytes = len(frame)
    del frame  # two bytes a weight on the host
    raw = sum(ent["nbytes"] for ent in layout.manifest_of(trainer_params))
    print(f"{arch}: weights reconstructed from a quantized update of "
          f"{frame_bytes:,} bytes ({frame_bytes / raw:.2%} of the trainer "
          f"tree's {raw:,}) in " + ", ".join(
              f"{k} {v:.2f} s" for k, v in transfer_s.items()))
    axes = batch_axes(cfg, dev)

    with torch.inference_mode():
        # one warm-up step at each batch size, off the clock
        serve = make_serve_step(cfg)
        for n in (1, b):
            serve(params, registry.init_decode_state(cfg, n, 2, device=dev),
                  first[:n])
        synchronize(dev)

        # --- shared route: the prefix once at batch 1, fanned out to B ----
        t0 = time.perf_counter()
        state1 = decode_prefix(cfg, params, prefix, total, dev)
        shared_state = fan_out(state1, axes, b)
        synchronize(dev)
        prefix_s = time.perf_counter() - t0
        del state1
        t1 = time.perf_counter()
        tokens = continue_batch(cfg, params, shared_state, first, gen_len)
        synchronize(dev)
        t2 = time.perf_counter()
        continue_s, shared_s = t2 - t1, t2 - t0
        print(f"shared prefix of {p} tokens decoded once in {prefix_s:.3f} s, "
              f"state fanned out x{b}; {b}x{gen_len} tokens in "
              f"{continue_s:.3f} s; route {shared_s:.3f} s "
              f"({b * gen_len / max(shared_s, 1e-9):.1f} new tok/s greedy)")
        print("sample token ids:", tokens[0][:8].tolist())

        # --- per-request route: each request decodes the prefix alone -----
        t0 = time.perf_counter()
        alone, gaps, scales = zip(*(decode_alone(cfg, params, prefix,
                                                 first[i:i + 1], gen_len,
                                                 total) for i in range(b)))
        alone, gaps, scales = (torch.stack(x) for x in (alone, gaps, scales))
        synchronize(dev)
        alone_s = time.perf_counter() - t0
    print(f"per-request route (each prefix decoded alone): {alone_s:.3f} s "
          f"({b * gen_len / max(alone_s, 1e-9):.1f} new tok/s); the shared "
          f"route took {shared_s / max(alone_s, 1e-9):.2f}x its time")
    tokens_h, alone_h = tokens.cpu(), alone.cpu()
    flips = check_flips(cfg, tokens_h, alone_h, gaps.cpu(), scales.cpu())
    print(f"shared vs alone: smallest top-2 gap {flips['min_gap']:.3e}, "
          f"flips {flips['flips'] or 'none'}")
    return {"frame_bytes": frame_bytes, "raw_bytes": raw, "params": params,
            "transfer_s": transfer_s,
            "tokens": tokens_h, "alone": alone_h, **flips,
            "prefix_s": prefix_s, "continue_s": continue_s,
            "shared_s": shared_s, "alone_s": alone_s,
            "shared_tok_s": b * gen_len / max(shared_s, 1e-9),
            "alone_tok_s": b * gen_len / max(alone_s, 1e-9)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (the JAX example always takes it)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefix-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    trainer_params = registry.init_params(cfg, 0, dev)
    prefix = torch.randint(0, cfg.vocab_size, (args.prefix_len,),
                           generator=torch.Generator().manual_seed(0))
    first = torch.randint(0, cfg.vocab_size, (args.batch,),
                          generator=torch.Generator().manual_seed(1))
    return run(cfg, trainer_params, prefix, first, args.gen_len, dev)


if __name__ == "__main__":
    main()
