"""What a step costs, counted as it runs (counterpart of the reference's
``repro/launch/hlo_cost.py``, which reads the compiled HLO; torch has none,
so the port counts the ops one eager call dispatches).

    r = analyze(serve_step, cfg, fkv, params, state, tokens)
    r["flops"], r["bytes"], r["link_bytes"], r["kernels"], r["per_op"]

* ``flops``: the products and convolutions that
  ``torch.utils.flop_counter.FlopCounterMode`` counts (``2 m n k`` a
  product, as the reference's ``_dot_flops``), plus the operations of each
  hand-written kernel launch.
* ``bytes``: for each aten op, the bytes of its tensor operands and of its
  results; views, allocations and ops that return no tensor move nothing.
  An eager step's ops each read their inputs from and write their outputs to
  memory, so this is an upper bound on the HBM traffic: a fused kernel would
  keep some of it in registers, and the L2 keeps some of what is reused.
  Plus each kernel launch's HBM bytes.
* ``link_bytes``: the bytes the kernels move across PCIe (a pinned host
  pool).
* ``kernels``: ``{name: {launches, bytes, link_bytes, flops}}``. The hand
  kernels are ctypes calls that no dispatch mode sees, so each wrapper of
  ``kernels/ops.py`` reports its launch with its ``kernels/cost`` cost
  inside ``ops.counting``, on the card and on the meta device alike.
* ``per_op``: ``{aten op: {count, flops, bytes}}``; ``top_ops`` ranks it.
* ``peak_live_bytes``: an estimate of the most tensor bytes alive at once
  among the results the step made (views excluded; a result freed while a
  view of it lives is no longer counted); the inputs come on top.

Run on the meta device, a step allocates nothing and runs no kernel, yet
takes the card's branches (``repro_torch.resolve_device("meta")``), so it
counts what the step on the card would do; ``chip_smoke.py`` holds the two
counts equal for one llama31-8b decode step.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

aten = torch.ops.aten
# ops that allocate or annotate without moving a byte
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default,
               aten.record_stream.default, aten.lift_fresh.default, aten.detach.default,
               aten.set_.source_Storage_storage_offset, aten.resize_.default}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteMode(TorchDispatchMode):
    """Sums each op's operand and result bytes, per op, and follows the
    results' live bytes."""

    def __init__(self):
        super().__init__()
        self.per_op = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _track(self, t):
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        rec = self.per_op[str(func.overloadpacket.__name__)]
        rec["count"] += 1
        if not outs or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        if func not in _NO_TRAFFIC:
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            rec["bytes"] += n
            self.bytes += n
        for t in outs:          # an in-place op's result is its operand, alive already
            if not t._is_view() and not any(t is a for a in ins):
                self._track(t)
        return out


class _KernelCounter:
    def __init__(self):
        self.kernels = {}

    def kernel(self, name, cost):
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0, "link_bytes": 0,
                                           "flops": 0})
        k["launches"] += 1
        k["bytes"] += cost["hbm_bytes"]
        k["link_bytes"] += cost["link_bytes"]
        k["flops"] += cost["flops"]


def analyze(fn, *args, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once and returns its count (module
    docstring): ``flops``, ``bytes``, ``link_bytes``, ``aten_flops``,
    ``aten_bytes``, ``kernels``, ``per_op``, ``peak_live_bytes`` and
    ``out``, what ``fn`` returned."""
    bm = _ByteMode()
    kc = _KernelCounter()
    fc = FlopCounterMode(display=False)
    with ops.counting(kc), fc, bm:
        out = fn(*args, **kwargs)
    flop_by_op = defaultdict(int)
    for packet, n in fc.get_flop_counts().get("Global", {}).items():
        flop_by_op[str(getattr(packet, "__name__", packet))] += int(n)
    per_op = {name: {"count": r["count"], "flops": flop_by_op.get(name, 0), "bytes": r["bytes"]}
              for name, r in bm.per_op.items()}
    aten_flops = int(fc.get_total_flops())
    k_flops = sum(k["flops"] for k in kc.kernels.values())
    k_bytes = sum(k["bytes"] for k in kc.kernels.values())
    return {"flops": aten_flops + k_flops, "bytes": bm.bytes + k_bytes,
            "link_bytes": sum(k["link_bytes"] for k in kc.kernels.values()),
            "aten_flops": aten_flops, "aten_bytes": bm.bytes,
            "kernels": kc.kernels, "per_op": per_op, "peak_live_bytes": bm.peak,
            "out": out}


def top_ops(result, key="flops", n=8):
    """The ``n`` ops of ``result["per_op"]`` with the most ``key`` (counterpart
    of ``hlo_cost.top_computations``) -> [(name, {count, flops, bytes})]."""
    items = sorted(result["per_op"].items(), key=lambda kv: -kv[1][key])
    return items[:n]
