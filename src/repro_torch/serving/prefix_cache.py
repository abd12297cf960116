"""Radix-trie prefix cache: token-keyed reuse of prefilled K/V (reference
``repro/serving/prefix_cache.py``).

A request whose prompt shares a prefix with an earlier prompt skips the
forward pass over the matched span: the engine runs only the suffix through
``models.model.prefill_extend`` and rebuilds the decode state from the
cached K/V and the suffix's.

Payloads are lists of tensors whose axis 0 is the token axis: here one
(T, kv, dh) K and one V tensor a layer, at the K/V's own dtype (numpy has no
bfloat16, so the port keeps tensors). Each trie node owns a token segment
and the payload slice covering it, so shared prefixes are stored once
(path compression) and a lookup is O(L). A match may stop inside a
segment; only inserts split nodes.

Where the payload lives: an insert stores copies of the span it adds. A
slice of a CUDA tensor is copied into pinned host memory by the copy engine,
ordered on the current stream (``non_blocking``), as the reference keeps its
payload on the host; a CPU tensor is cloned. Nothing here reads a payload
on the host afterwards: splitting a node and matching inside a segment take
views, and ``match_parts`` hands out the pieces for the engine to copy back
to the card on the same stream (``copy_parts``).

Eviction is LRU over leaves with a token-count capacity, as the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

Payload = List[torch.Tensor]        # per-layer tensors, token axis 0


def _view_payload(payload: Payload, start: int, stop: int) -> Payload:
    return [a[start:stop] for a in payload]


def _store_payload(payload: Payload, start: int, stop: int) -> Payload:
    """Owned copies of tokens [start, stop): one pinned host block for CUDA
    tensors (filled by non-blocking copies on the current stream), clones
    for CPU ones and for meta ones (nothing to pin)."""
    parts = [a[start:stop] for a in payload]
    if not parts or not parts[0].is_cuda:
        return [p.clone(memory_format=torch.contiguous_format) for p in parts]
    dtype = parts[0].dtype
    assert all(p.dtype == dtype for p in parts), "one dtype per payload"
    block = torch.empty(sum(p.numel() for p in parts), dtype=dtype, pin_memory=True)
    out, i = [], 0
    for p in parts:
        dst = block[i: i + p.numel()].view(p.shape)
        dst.copy_(p, non_blocking=True)
        out.append(dst)
        i += p.numel()
    return out


def _payload_nbytes(payload: Payload) -> int:
    return sum(a.numel() * a.element_size() for a in payload)


def copy_parts(parts: Sequence[Payload], out: Payload) -> Payload:
    """Copy matched pieces (``match_parts``) into ``out``'s leading tokens,
    one tensor a payload entry (device buffers: non-blocking copies on the
    current stream). Returns ``out``."""
    off = 0
    for part in parts:
        n = part[0].shape[0]
        for dst, src in zip(out, part):
            dst[off: off + n].copy_(src, non_blocking=True)
        off += n
    return out


class _Node:
    __slots__ = ("tokens", "payload", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], payload: Optional[Payload],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.payload = payload                    # None only for the root
        self.children: Dict[int, _Node] = {}      # first token -> child
        self.parent = parent
        self.last_used = 0

    def is_leaf(self) -> bool:
        return not self.children


class RadixPrefixCache:
    """LRU-evicted radix trie over token ids with K/V payloads.

    ``capacity_tokens`` bounds the cached tokens (the sum of segment
    lengths); 0 disables the cache (every match misses, inserts are
    dropped)."""

    def __init__(self, capacity_tokens: int):
        self.capacity_tokens = int(capacity_tokens)
        self.root = _Node((), None, None)
        self._clock = 0
        self.total_tokens = 0
        # telemetry, read by serving.metrics
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.insert_count = 0
        self.evictions = 0

    # -- internals -----------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: _Node):
        t = self._tick()
        while node is not None:
            node.last_used = t
            node = node.parent

    @staticmethod
    def _common_len(a: Sequence[int], b: Sequence[int]) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _split(self, node: _Node, at: int) -> _Node:
        """Split ``node``'s segment at offset ``at``; returns the upper half.
        Both halves are views of the node's payload."""
        upper = _Node(node.tokens[:at], _view_payload(node.payload, 0, at), node.parent)
        upper.last_used = node.last_used
        upper.children[node.tokens[at]] = node
        node.parent.children[node.tokens[0]] = upper
        node.tokens = node.tokens[at:]
        node.payload = _view_payload(node.payload, at, at + len(node.tokens))
        node.parent = upper
        return upper

    # -- public API ----------------------------------------------------
    def match_parts(self, tokens: Sequence[int]) -> Tuple[int, List[Payload]]:
        """Longest cached prefix of ``tokens`` as (n_matched, the payload
        pieces covering it in order, views). The matched path (and, for a
        partial segment match, the containing node) is LRU-touched."""
        tokens = tuple(tokens)
        self.lookup_tokens += len(tokens)
        node, off, parts = self.root, 0, []
        while off < len(tokens):
            child = node.children.get(tokens[off])
            if child is None:
                break
            n = self._common_len(child.tokens, tokens[off:])
            if n == 0:
                break
            parts.append(_view_payload(child.payload, 0, n)
                         if n < len(child.tokens) else child.payload)
            off += n
            node = child
            if n < len(child.tokens):
                break
        self._touch(node)
        if off == 0:
            self.misses += 1
            return 0, []
        self.hits += 1
        self.hit_tokens += off
        return off, parts

    def insert(self, tokens: Sequence[int], payload: Payload) -> int:
        """Insert ``tokens`` with its full-span payload; returns the number
        of newly stored tokens (cached prefix spans are deduplicated)."""
        if self.capacity_tokens <= 0 or not len(tokens):
            return 0
        tokens = tuple(tokens)
        node, off = self.root, 0
        while off < len(tokens):
            child = node.children.get(tokens[off])
            if child is None:
                break
            n = self._common_len(child.tokens, tokens[off:])
            if n < len(child.tokens):
                if n == 0:
                    break
                child = self._split(child, n)
            node, off = child, off + n
        added = len(tokens) - off
        if added:
            leaf = _Node(tokens[off:], _store_payload(payload, off, len(tokens)), node)
            node.children[tokens[off]] = leaf
            node = leaf
            self.total_tokens += added
        self._touch(node)
        self.insert_count += 1
        self._evict_to_capacity()
        return added

    def _evict_to_capacity(self):
        # evict leaves in LRU order until under capacity; parents that
        # became leaves are picked up by the next walk
        while self.total_tokens > self.capacity_tokens:
            leaves = self._leaves()
            if not leaves:
                return
            leaves.sort(key=lambda n: n.last_used)
            for victim in leaves:
                if self.total_tokens <= self.capacity_tokens:
                    break
                del victim.parent.children[victim.tokens[0]]
                self.total_tokens -= len(victim.tokens)
                self.evictions += 1

    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and n.is_leaf():
                out.append(n)
            stack.extend(n.children.values())
        return out

    # -- accounting ----------------------------------------------------
    def nbytes(self) -> int:
        total, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            if n.payload is not None:
                total += _payload_nbytes(n.payload)
            stack.extend(n.children.values())
        return total

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def hit_token_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens,
                "hit_rate": self.hit_rate,
                "hit_token_rate": self.hit_token_rate,
                "cached_tokens": self.total_tokens,
                "evictions": self.evictions,
                "nbytes": self.nbytes()}
