"""Prefix-sharing context cache for FFM serving (port of
``repro/serving/prefix_cache.py``; paper §5, radix-tree keys).

The paper keys its context cache on the *raw request strings* via a radix
tree, so two requests whose contexts agree on a leading run of fields share
the cached work for that run. This module is the structured equivalent over
hashed features: a trie whose edges are ``(idx, val)`` field tokens and whose
nodes can hold a *prefix partial* — the FFM context state restricted to the
fields along the path (``repro_torch.core.ffm.extend_context_prefix``
format). The states hold device tensors; the trie and its keys live on the
host.

A lookup walks the trie as deep as the request's tokens match and returns the
deepest node holding a partial that is (a) stamped with the current weight
generation and (b) complete up to that node's depth. The serving engine then
computes only the context *tail* from there (batched across a miss group).

Storage policy: one insert stores the full-depth state once and registers
entry pointers at a closed set of *checkpoint depths* (multiples of
``stride`` plus the full depth). Because the j-major prefix pair order makes
any shallower depth a pure slice of a deeper state, every checkpoint shares
the same underlying arrays — memory cost is one full state per cached
context, not one per depth. The closed depth set also closes the set of tail
shapes the engine must compile (see ``InferenceEngine.warmup``).

Eviction is LRU over *full contexts*: each node counts the cached full
contexts routed through it, and evicting a context prunes every node whose
count drops to zero — exactly the radix-tree behaviour of dropping a leaf and
any run of edges only it used.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ffm


class _Node:
    """One trie node; ``entries`` maps a weight generation to ``(depth,
    state)`` where ``state`` is a full-depth prefix state usable up to
    ``depth`` fields.

    At most the **two newest** generations are retained per node — the cache
    analogue of the engine's double-buffered params slot: the update pipe
    pre-warms partials for generation g+1 while scorers still hit g, and the
    atomic publish flips traffic onto already-warm entries. One generation
    back stays valid for scorers that snapshotted weights just before a
    swap."""

    __slots__ = ("children", "entries", "refs")

    def __init__(self):
        self.children: Dict[bytes, _Node] = {}
        self.entries: Dict[int, Tuple[int, Dict]] = {}
        self.refs = 0

    @property
    def entry(self) -> Optional[Tuple[int, int, Dict]]:
        """Newest generation's ``(generation, depth, state)`` (introspection/
        test compatibility view of ``entries``)."""
        if not self.entries:
            return None
        gen = max(self.entries)
        depth, state = self.entries[gen]
        return (gen, depth, state)


def context_tokens(ctx_idx: np.ndarray, ctx_val: np.ndarray) -> Tuple[bytes, ...]:
    """Per-field ``(idx, val)`` byte tokens — the trie's edge alphabet.
    One ``tobytes`` per array, sliced per field (hot-path cheap).
    ``context_from_tokens`` is the inverse; keep the two in sync."""
    ctx_idx = np.ascontiguousarray(ctx_idx)
    ctx_val = np.ascontiguousarray(ctx_val)
    bi, bv = ctx_idx.tobytes(), ctx_val.tobytes()
    si, sv = ctx_idx.itemsize, ctx_val.itemsize
    return tuple(bi[i * si:(i + 1) * si] + bv[i * sv:(i + 1) * sv]
                 for i in range(ctx_idx.shape[0]))


_IDX_BYTES = np.dtype(np.int32).itemsize  # engine keys tokens as (i32, f32)


def context_from_tokens(tokens: Sequence[bytes]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`context_tokens` for int32/float32 contexts (the
    engine's canonical request dtypes): tokens -> ``(ctx_idx, ctx_val)``."""
    idx = np.frombuffer(b"".join(t[:_IDX_BYTES] for t in tokens), np.int32)
    val = np.frombuffer(b"".join(t[_IDX_BYTES:] for t in tokens), np.float32)
    return idx, val


class PrefixCache:
    """LRU-bounded prefix tree over context field tokens.

    ``max_entries`` bounds the number of cached *full contexts* (``len(self)``
    reports exactly that, matching the flat-cache semantics it replaces);
    checkpoint partials ride along with their context and are pruned with it.
    ``stride=None`` disables intermediate checkpoints — only full-depth
    entries are stored, which reproduces a flat exact-match cache inside
    the same structure. ``depths`` overrides ``stride`` with
    an explicit checkpoint-depth set (adaptive depths picked from an observed
    hit histogram — ``InferenceEngine.suggest_checkpoint_depths``); the full
    depth is always included.
    """

    def __init__(self, fc: int, max_entries: int = 4096,
                 stride: Optional[int] = 4,
                 depths: Optional[Sequence[int]] = None):
        if fc < 1:
            raise ValueError("need at least one context field")
        if stride is not None and stride < 1:
            raise ValueError("stride must be >= 1 (or None to disable)")
        if depths is not None:
            depths = sorted(set(int(d) for d in depths) | {fc})
            if depths[0] < 1 or depths[-1] > fc:
                raise ValueError(f"checkpoint depths must lie in [1, {fc}]")
        self.fc = fc
        self.max_entries = max_entries
        self.stride = stride
        self.depths = depths
        self.root = _Node()
        self._lru: "OrderedDict[Tuple[bytes, ...], None]" = OrderedDict()
        # depth of cached prefix actually reused per resolved context; filled
        # by the caller (which may re-look-up while resolving a miss burst,
        # so it alone knows the final reuse depth)
        self.hit_depths: Counter = Counter()

    def checkpoint_depths(self) -> List[int]:
        """The closed set of depths at which partials are stored."""
        if self.depths is not None:
            return list(self.depths)
        if self.stride is None:
            return [self.fc]
        ds = list(range(self.stride, self.fc, self.stride))
        return ds + [self.fc]

    def tail_lengths(self) -> List[int]:
        """Closed set of tail shapes a lookup can leave to compute (misses at
        depth 0 or any checkpoint depth short of the full context)."""
        return sorted({self.fc - d for d in [0] + self.checkpoint_depths()
                       if d < self.fc}, reverse=True)

    def __len__(self) -> int:
        return len(self._lru)

    def keys(self) -> List[Tuple[bytes, ...]]:
        """Token tuples of every cached full context (LRU order, oldest
        first). Snapshot copy — safe to iterate while lookups proceed."""
        return list(self._lru.keys())

    # -- lookup / insert -----------------------------------------------------
    def lookup(self, tokens: Sequence[bytes], generation: int
               ) -> Tuple[int, Optional[Dict]]:
        """Walk the trie along ``tokens``; return the deepest cached prefix
        ``(depth, state)`` valid under ``generation`` (``(0, None)`` if no
        prefix is cached). ``depth == len(tokens)`` is a full-context hit."""
        node, depth = self.root, 0
        best_depth, best_state = 0, None
        for d, tok in enumerate(tokens, start=1):
            node = node.children.get(tok)
            if node is None:
                break
            e = node.entries.get(generation)
            if e is not None and e[0] >= d:
                best_depth, best_state = d, e[1]
        if best_depth == len(tokens):
            self._lru.move_to_end(tuple(tokens))
        return best_depth, best_state

    def insert(self, tokens: Sequence[bytes], generation: int,
               state: Dict) -> None:
        """Register a freshly computed full-depth prefix ``state`` for
        ``tokens``, installing checkpoint entries along the path."""
        key = tuple(tokens)
        if len(key) != self.fc:
            raise ValueError(f"expected {self.fc} tokens, got {len(key)}")
        depths = set(self.checkpoint_depths())
        is_new = key not in self._lru
        node = self.root
        if is_new:
            node.refs += 1
        for d, tok in enumerate(key, start=1):
            child = node.children.get(tok)
            if child is None:
                child = node.children[tok] = _Node()
            if is_new:
                child.refs += 1
            if d in depths:
                # per-generation slots: an insert never clobbers another
                # generation's partial (a scorer on a pre-swap snapshot and
                # the pipe pre-warming the next generation coexist); within a
                # generation, deeper-usable entries win. Only the two newest
                # generations are retained (double-buffer bound).
                e = child.entries.get(generation)
                if e is None or e[0] < self.fc:
                    child.entries[generation] = (self.fc, state)
                    while len(child.entries) > 2:
                        del child.entries[min(child.entries)]
            node = child
        self._lru[key] = None
        self._lru.move_to_end(key)
        while len(self._lru) > self.max_entries:
            self._evict()

    def _evict(self) -> None:
        key, _ = self._lru.popitem(last=False)
        node = self.root
        node.refs -= 1
        path = []
        for d, tok in enumerate(key, start=1):
            path.append((node, tok))
            node = node.children[tok]
            node.refs -= 1
            # a surviving shared node may hold the *evicted* context's
            # full-depth state; truncate it to the node's own depth (copied
            # slices) so eviction really releases the full state and memory
            # stays bounded per *live* context
            if node.refs > 0:
                for gen, (depth_g, s) in list(node.entries.items()):
                    if depth_g > d:
                        node.entries[gen] = (d, {
                            k: v.clone()
                            for k, v in ffm.slice_context_prefix(s, d).items()})
        # prune the unshared suffix of the path (radix-tree leaf drop)
        for parent, tok in reversed(path):
            child = parent.children[tok]
            if child.refs <= 0:
                del parent.children[tok]
            else:
                break
