"""Paged KV slot pool: maps requests onto physical batch rows (reference
``repro/serving/kv_slots.py``).

The decode state has a fixed batch: the slot count. Admission and
completion are per-row writes, in place, with ``paging.slot_write_leaf``:

  * ``claim(slot)`` empties a slot's row and hands out its per-layer views,
    so ``models.model.prefill(into=...)`` builds the request's state
    straight into the row: the pool pages land in the row's pinned host
    memory and the admission copies none of them (~34 MB a layer at
    llama31-8b's width and 8192 tokens);
  * ``insert(src, slot)`` writes a B=1 state into the row; leaves that
    already are the row's views (what ``claim`` gave out) are left alone,
    so after an in-place prefill only the leaves the retriever replaced
    (selection buffers, lengths, the centroid index) are copied;
  * ``free(slot)`` returns the slot and marks it dirty; the reset to the
    empty state (the pool pages aside, see ``POOL_KEYS``) is lazy
    (``flush_resets``, called right before a decode window), so a slot
    refilled at the same boundary is written once;
  * ``swap_out(slot)`` / ``swap_in(host_state, slot)``, the preemption
    swap: the row's whole state to host tensors at its stored dtypes and
    back, bit for bit (``offload.swap_state_to_host``).

Under tensor-parallel serving (``mesh``) a layer's retrieval state holds
every KV-head-group shard's leaves under ``"<shard>/<key>"``, each on its
shard's device (``core/sharded_retrieval``): every operation above acts on
each leaf's rows, so on every shard's, and the pool accounting and the
pinned check count every shard's pool.

Under a ("data", "model") compute mesh the slots split over the data
groups where they divide (``models.model.serving_groups``): slot s is row
s % b of group s // b (b slots a group), and a layer's leaves are keyed
``"<group>:<shard>/<key>"`` on that group's shards. Every operation above
acts on the slot's group's leaves at its row there; ``claim`` hands out
those views under their keys, and ``insert``/``swap_in`` write a state
made in any group into the slot's group (``group_of``). The recurrent
layers' state blocks (``"<group>:<shard>/h"``, ...), the cross-attention's
``xk``/``xv`` and, under speculative decoding, the drafter's table (a dict
of each group's, ``"<group>:0/draft_tab"``) ride the same per-leaf
operations.

Every write first makes the current stream wait for each layer's staged
recall (``recall_pipeline.wait_staged``): the side stream writes the
``sel_k``/``sel_v`` tensors and reads the pool rows. Writes and reads of the
pinned pool run on the host, so they first wait for the whole card.
"""
from __future__ import annotations

from typing import List, Optional, Set

import torch

from repro_torch import resolve_device
from repro_torch.core import offload, paging
from repro_torch.core.recall_pipeline import wait_staged
from repro_torch.launch.mesh import is_compute_mesh
from repro_torch.models.model import init_decode_state, serving_groups
from repro_torch.quant.accounting import pool_bytes_detail
from repro_torch.sharding.rules import base_key

# top-level lanes of the decode state beside "layers", each batched on
# axis 0: the positions and, under speculative decoding, the drafter's
# successor table (empty value -1)
TOP_LANES = ("pos", "pos_host", "draft_tab")
_TOP_FILL = {"pos": 0, "pos_host": 0, "draft_tab": -1}

# the pool payload and its scales: pages past a row's length are written (at
# page completion) before a selection can reach them, so no reset clears
# them: the previous occupant's bytes stay instead of ~1 GB of host memset
# per slot at llama31-8b's width
POOL_KEYS = ("pool", "pool_scale")


def _tensors(layer):
    return {k: t for k, t in layer.items() if isinstance(t, torch.Tensor)}


class SlotPool:
    """Fixed-capacity pool of physical batch slots over one decode state
    (``self.state``: ``{"layers": [...], "pos", "pos_host"}`` at batch
    ``num_slots``), with the pool in pinned host memory under
    ``fkv.offload == "host"`` as everywhere in the port."""

    def __init__(self, cfg, fkv, num_slots: int, max_len: int,
                 state_dtype=torch.float32, device="cuda", mesh=None):
        self.cfg, self.fkv = cfg, fkv
        self.num_slots = num_slots
        self.max_len = max_len
        self.state_dtype = state_dtype
        self.device = resolve_device(device)
        self.state = init_decode_state(cfg, fkv, num_slots, max_len, state_dtype, self.device,
                                       mesh)
        # a compute mesh's data groups: slot s is row s % b of group s // b
        self._grouped = is_compute_mesh(mesh)
        self.n_groups = serving_groups(cfg, mesh, num_slots) if self._grouped else 1
        self.group_rows = num_slots // self.n_groups
        # every leaf of an empty state is one constant (zeros, or -1 for
        # the position and page-id leaves, -1e9 for RaaS's timestamps,
        # -1e30 for the mLSTM's m, 1 for the sLSTM's n; whisper's xk/xv
        # zeros): read them off a tiny one, a layer at a time (gemma2's
        # local layers hold other leaves than its global ones; an empty
        # leaf, a sink of 0 tokens, takes 0), by key without the shard
        tiny = init_decode_state(cfg, fkv, 1, fkv.page_size, state_dtype, "cpu")
        self._fill = [{k: t.flatten()[0].item() if t.numel() else 0
                       for k, t in _tensors(layer).items()} for layer in tiny["layers"]]
        # a pinned pool, which the host touches directly (never on meta: its
        # stand-in holds nothing to wait for)
        self._host = self.device.type == "cuda" and any(
            not t.is_cuda for layer in self.state["layers"] for t in _tensors(layer).values())
        # the cards the state lives on: the primary one and every TP shard's
        self._cards = sorted({t.device for layer in self.state["layers"]
                              for t in _tensors(layer).values() if t.is_cuda}, key=str)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._dirty: Set[int] = set()
        self.owner: List[Optional[int]] = [None] * num_slots
        self.allocs = 0

    # -- bookkeeping -----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, owner_uid: int) -> int:
        """Take a free slot; its pending reset is dropped, as the
        reference's, because the admission overwrites the row. A slot held
        by a chunked prefill over several rounds therefore keeps stepping
        what its row held (the previous occupant's state, or an idle row's)
        until ``claim`` empties it at the final chunk: exactly the
        reference's row, which matters where rows meet (a MoE router's
        capacity, ``models/moe``)."""
        slot = self._free.pop()
        assert self.owner[slot] is None, f"slot {slot} already owned by {self.owner[slot]}"
        self._dirty.discard(slot)
        self.owner[slot] = owner_uid
        self.allocs += 1
        return slot

    def free(self, slot: int):
        assert self.owner[slot] is not None, f"slot {slot} already free"
        self.owner[slot] = None
        self._free.append(slot)
        self._dirty.add(slot)

    def group_of(self, slot: int) -> int:
        """The data group whose shards hold ``slot`` (0 without a compute
        mesh)."""
        return slot // self.group_rows if self._grouped else 0

    def _rows(self, layer, slot: int):
        """(key, leaf, row) for each leaf of ``layer`` that holds ``slot``:
        every leaf at row ``slot``, or under a compute mesh the slot's
        group's leaves at its row there."""
        if not self._grouped:
            return [(k, t, slot) for k, t in _tensors(layer).items()]
        g, r = divmod(slot, self.group_rows)
        pre = f"{g}:"
        return [(k, t, r) for k, t in _tensors(layer).items() if k.startswith(pre)]

    def _key_in(self, key: str, slot: int) -> str:
        """``key`` of a state made in any data group as the slot's group's."""
        if not self._grouped:
            return key
        return f"{self.group_of(slot)}:{key.split(':', 1)[1]}"

    def pool_bytes(self) -> int:
        """Physical host-tier bytes (packed payload + scales), all slots."""
        return self.pool_bytes_detail()["physical"]

    def pool_bytes_detail(self) -> dict:
        """Payload, scales, physical and dense-equivalent pool bytes."""
        return pool_bytes_detail(self.state["layers"], self.cfg.d_head,
                                 dense_itemsize=torch.finfo(self.state_dtype).bits // 8)

    # -- state surgery -----------------------------------------------------
    def _settle(self):
        """Order a row write or read after the work in flight: the current
        stream waits for every layer's staged recall; with a pinned pool,
        whose rows the host touches directly, the host waits for the card."""
        for layer in self.state["layers"]:
            wait_staged(layer)
        if self._host:
            for card in self._cards:
                torch.cuda.synchronize(card)

    def _reset_row(self, slot: int):
        """Row ``slot`` to the empty state, all but the pool pages."""
        for layer, fill in zip(self.state["layers"], self._fill):
            for k, t, r in self._rows(layer, slot):
                if base_key(k) not in POOL_KEYS:
                    paging.slot_read_leaf(t, r).fill_(fill[base_key(k)])
        for k in self._top():
            self.state[k][slot] = _TOP_FILL[k]
        for k in self._grouped_top():
            for _, t, r in self._rows(self.state[k], slot):
                paging.slot_read_leaf(t, r).fill_(_TOP_FILL[k])

    def _top(self):
        """The top-level lanes held as one (B, ...) tensor."""
        return [k for k in TOP_LANES if isinstance(self.state.get(k), torch.Tensor)]

    def _grouped_top(self):
        """The top-level lanes held per data group (a compute mesh's drafter
        tables), a dict keyed like a layer's leaves."""
        return [k for k in TOP_LANES if isinstance(self.state.get(k), dict)]

    def flush_resets(self):
        """Reset the slots freed since the last flush and not refilled, so
        idle rows step from the empty state."""
        if not self._dirty:
            return
        self._settle()
        for slot in sorted(self._dirty):
            self._reset_row(slot)
        self._dirty.clear()

    def claim(self, slot: int) -> list:
        """Empty row ``slot`` and return its per-layer B=1 views for
        ``prefill(into=...)``."""
        self._settle()
        self._reset_row(slot)
        return [{k: paging.slot_read_leaf(t, r) for k, t, r in self._rows(layer, slot)}
                for layer in self.state["layers"]]

    def insert(self, src_state, slot: int):
        """Write a B=1 decode state into row ``slot``."""
        self._settle()
        r = slot - self.group_of(slot) * self.group_rows if self._grouped else slot
        for dst, src in zip(self.state["layers"], src_state["layers"]):
            for k, t in _tensors(src).items():
                paging.slot_write_leaf(dst[self._key_in(k, slot)], t, r)
        for k in self._top():
            if k in src_state:
                paging.slot_write_leaf(self.state[k], src_state[k], slot)
        for k in self._grouped_top():
            for key, t in src_state.get(k, {}).items():
                paging.slot_write_leaf(self.state[k][self._key_in(key, slot)], t, r)

    def extract(self, slot: int):
        """Row ``slot`` as a B=1 state of copies (tests, migration)."""
        self._settle()
        return {"layers": [{k: paging.slot_read_leaf(t, r).clone()
                            for k, t, r in self._rows(layer, slot)}
                           for layer in self.state["layers"]],
                **{k: paging.slot_read_leaf(self.state[k], slot).clone() for k in self._top()},
                **{k: {key: paging.slot_read_leaf(t, r).clone()
                       for key, t, r in self._rows(self.state[k], slot)}
                   for k in self._grouped_top()}}

    def swap_out(self, slot: int):
        """Row ``slot``'s whole B=1 state as host tensors at their stored
        dtypes (the caller frees the slot): the pool at its packed width and
        its scales, the summaries, the rings, the selection buffers
        ``sel_k``/``sel_v``/``sel_idx`` (the staged recall, finished first),
        ``qprev``, the lengths and the top-level lanes (``pos``,
        ``pos_host`` and the drafter's ``draft_tab``)."""
        self._settle()
        return offload.swap_state_to_host(
            {"layers": [{k: paging.slot_read_leaf(t, r) for k, t, r in self._rows(layer, slot)}
                        for layer in self.state["layers"]],
             **{k: paging.slot_read_leaf(self.state[k], slot) for k in self._top()},
             **{k: {key: paging.slot_read_leaf(t, r) for key, t, r in
                    self._rows(self.state[k], slot)} for k in self._grouped_top()}})

    def swap_in(self, host_state, slot: int):
        """Write a ``swap_out`` state into row ``slot`` (allocated by the
        caller), every leaf at its stored dtype: bit for bit. Card rows take
        non-blocking copies from the pinned host tensors on the current
        stream; host rows (the pinned pool) are copied on the host after
        ``_settle``."""
        self._settle()
        r = slot - self.group_of(slot) * self.group_rows if self._grouped else slot
        for dst, src in zip(self.state["layers"], host_state["layers"]):
            for k, t in src.items():
                paging.slot_read_leaf(dst[self._key_in(k, slot)], r).copy_(t, non_blocking=True)
        for k in self._top():
            paging.slot_read_leaf(self.state[k], slot).copy_(host_state[k], non_blocking=True)
        for k in self._grouped_top():
            for key, t in host_state[k].items():
                paging.slot_read_leaf(self.state[k][self._key_in(key, slot)], r).copy_(
                    t, non_blocking=True)

    def reset_all(self):
        self._settle()
        for slot in range(self.num_slots):
            self._reset_row(slot)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._dirty = set()
        self.owner = [None] * self.num_slots
