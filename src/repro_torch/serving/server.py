"""Serving layer, both workloads (port of ``repro/serving/server.py``).

* ``FFMServer`` — the paper's path, a thin deployment wrapper over
  :class:`repro_torch.serving.engine.InferenceEngine`: weight updates arrive
  through the quantized-patch channel (cache-preserving hot swaps), and
  candidate-scoring requests go through the prefix-sharing context cache
  (§5) with cross-request candidate dedup, the candidate pairs on the
  kernels by default; it returns click probabilities.
* ``LLMServer`` — batched prefill (one forward fills the KV cache) + greedy
  decode. Where the JAX server has no batched prefill (``moe``, ``encdec``,
  the int8 cache) it warms the cache up one prompt token at a time through
  the serve step, and so does this one; an ``encdec`` model's cross caches
  stay zero there, as in the JAX server (``encdec.prefill_cross`` fills
  them for a caller with frames).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.config import FFMConfig, ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.convert import to_device
from repro_torch.models import registry, transformer
from repro_torch.serving.engine import InferenceEngine, ServeStats
from repro_torch.train.steps import make_serve_step


def _probabilities(logits: np.ndarray) -> np.ndarray:
    return torch.sigmoid(torch.from_numpy(logits)).numpy()


class FFMServer:
    """DeepFFM serving instance fed by the trainer's update channel, on one
    device (the card unless ``device="cpu"``).

    ``backend="cuda"`` (default) scores the candidate pairs on the kernels;
    ``"reference"`` is the plain-tensor oracle path. ``prefix_stride`` /
    ``dedup`` tune the engine's prefix-sharing context cache and
    cross-request candidate dedup; the defaults enable both. Weights arrive
    through :meth:`apply_update`, so bucket warmup (``engine.warmup``) is
    available once the first update lands.
    """

    def __init__(self, cfg: FFMConfig, model: str = "deepffm",
                 cache_entries: int = 4096, backend: str = "cuda",
                 prefix_stride: Optional[int] = 4, dedup: bool = True,
                 device: DeviceLike = None):
        self.engine = InferenceEngine(cfg, model, backend=backend,
                                      device=device,
                                      cache_entries=cache_entries,
                                      prefix_stride=prefix_stride,
                                      dedup=dedup)

    @property
    def cfg(self) -> FFMConfig:
        return self.engine.cfg

    @property
    def model(self) -> str:
        return self.engine.model

    @property
    def stats(self) -> ServeStats:
        return self.engine.stats

    @property
    def cache_hit_rate(self) -> float:
        return self.engine.cache_hit_rate

    def apply_update(self, update: bytes, manifest, like_params) -> None:
        """Ingest one trainer update (full file, patch or row delta) and
        hot-swap the weights; the context cache survives (stale entries
        refresh lazily)."""
        self.engine.apply_update(update, manifest, like_params)

    def submit_update(self, update: bytes, manifest=None,
                      like_params=None) -> bool:
        """Asynchronous :meth:`apply_update`: the frame is decoded on the
        engine's update-pipe thread, off the request path."""
        return self.engine.submit_update(update, manifest, like_params)

    def flush_updates(self, timeout: float = 30.0) -> bool:
        """Wait for every submitted update to publish. ``True``: drained
        (read ``engine.generation`` for the result); ``False``: timed out
        or the pipe was killed."""
        return self.engine.update_pipe().flush(timeout)

    def serve(self, ctx_idx, ctx_val, cand_idx, cand_val) -> np.ndarray:
        """Score one request; returns sigmoid probabilities (N,) float32."""
        return _probabilities(self.engine.score(ctx_idx, ctx_val, cand_idx,
                                                cand_val))

    def serve_batch(self, requests: Sequence[Tuple]) -> List[np.ndarray]:
        """Microbatched scoring: one forward for many requests."""
        return [_probabilities(s) for s in self.engine.score_batch(requests)]


class LLMServer:
    """Batched prefill + greedy decode on one device (the card unless
    ``device="cpu"``). ``last_prefill_s`` / ``last_decode_s`` hold the last
    :meth:`generate`'s split (the prefill or the stepwise warm-up, then the
    decode), host clock around work that ends in a synchronize on the
    card."""

    def __init__(self, cfg: ModelConfig, params, *, window: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.window = cfg, window
        self.params = to_device(params, self.device)
        self._serve = make_serve_step(cfg, window=window)
        self.stats = ServeStats()
        self.last_prefill_s = self.last_decode_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts, gen_len: int) -> torch.Tensor:
        """prompts: (B, P) token ids -> generated ids (B, gen_len) int32
        (greedy), on the server's device."""
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device)
        b, p = prompts.shape
        state = registry.init_decode_state(cfg, b, p + gen_len + 1,
                                           window=self.window,
                                           device=self.device)
        t0 = time.perf_counter()
        if (cfg.family in ("dense", "vlm") and cfg.attn_kind == "gqa"
                and cfg.kv_cache_dtype == "native"):
            logits, state = transformer.prefill(cfg, self.params, prompts,
                                                state, window=self.window)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:  # no batched prefill: the JAX server's stepwise warm-up
            tok = prompts[:, 0]
            for i in range(p):
                tok, state = self._serve(self.params, state, prompts[:, i])
        self._sync()
        t1 = time.perf_counter()
        outs = []
        for _ in range(gen_len):
            outs.append(tok)
            tok, state = self._serve(self.params, state, tok)
        gen = torch.stack(outs, 1) if outs else torch.zeros(
            (b, 0), dtype=torch.int32, device=self.device)
        self._sync()
        t2 = time.perf_counter()
        self.last_prefill_s, self.last_decode_s = t1 - t0, t2 - t1
        self.stats.record(t2 - t0, b * gen_len, requests=b)
        return gen
