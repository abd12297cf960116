"""Token sampling: greedy / temperature / top-p, drawn bit for bit as the
reference's (``repro/serving/sampling.py``) draws them.

Two entry points, as in the reference:

* ``sample(logits, cfg, key)``: the static engine's batch sampler, one key
  for the whole (B, V) draw.
* ``sample_step(logits, cfg, keys)``: the per-slot sampler the continuous
  scheduler runs inside the decode window, one key a row, each row drawing
  (V,) on its own.

Per-request key streams: ``request_key(seed, uid)`` seeds request ``uid``'s
stream and its token ``i`` is drawn with ``fold_in(request_key, i)``
(``step_keys`` folds one count a slot), so a request's tokens do not depend
on its slot, its neighbours or the host-read cadence.

The random numbers are JAX's threefry2x32 (``jax_default_prng_impl=
threefry2x32`` with ``jax_threefry_partitionable=True``) in torch integer
ops: a key is an int64 tensor (..., 2) holding the two uint32 words; the
bits of a draw of shape ``s`` come from the counter pair (0, flat index)
of each element, ``bits1 ^ bits2`` truncated to the draw's width (8 bits
for bf16, whose 7 mantissa bits take 8, 32 for fp32). ``uniform``,
``gumbel`` and ``categorical`` (argmax of logits plus Gumbel noise) follow
``jax.random`` at the logits' dtype, rounding after every operation as XLA
does; the temperature is rounded to that dtype before the division, as a
weakly typed scalar is. The top-p cutoff runs the reference's sort,
softmax (its exponentials summed unrounded in fp32, as XLA fuses them) and
cumulative sum (``_cumsum``: XLA's blocked scan, every partial sum rounded
to the dtype). A cutoff past the last token reads NaN, as
``jnp.take_along_axis`` does out of bounds, and masks every token: the draw
is then token 0, as the reference's.

Greedy is the exact argmax (first maximal index, as ``jnp.argmax``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 => greedy
    top_p: float = 1.0


# ---------------------------------------------------------------------------
# threefry2x32 on int64 tensors holding uint32 words
# ---------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & _MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """JAX's threefry2x32 hash of counters (x1, x2) under key (k1, k2); all
    int64 tensors (or ints) of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK32
    b = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return a, b


def PRNGKey(seed: int, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range: (2,) int64."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: key (..., 2), data an int or an integer tensor
    broadcast against the key's leading shape -> (..., 2)."""
    key = torch.as_tensor(key, dtype=torch.int64)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK32
    zero = torch.zeros_like(data)
    a, b = threefry2x32(key[..., 0], key[..., 1], zero, data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def request_key(seed: int, uid: int, device="cpu"):
    """The key seeding request ``uid``'s sample stream for one run."""
    return fold_in(PRNGKey(seed, device), int(uid))


def step_keys(slot_keys, counts):
    """Per-slot step keys: slot_keys (B, 2), counts (B,) -> (B, 2)."""
    return fold_in(slot_keys, counts.to(torch.int64))


def random_bits(key, bit_width: int, shape, device=None):
    """``jax.random.bits`` under the partitionable threefry: key (..., 2),
    one draw of ``shape`` a key -> int64 (..., *shape) of ``bit_width``
    bits. The counters are (0, flat index), so ``shape`` has fewer than
    2**32 elements."""
    key = torch.as_tensor(key, dtype=torch.int64)
    n = math.prod(shape)
    assert n < 2 ** 32
    lo = torch.arange(n, dtype=torch.int64, device=device or key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (a ^ b) & ((1 << bit_width) - 1)


def _nmant(dtype) -> int:
    return int(round(-math.log2(torch.finfo(dtype).eps)))


_INT_OF_BITS = {16: torch.int16, 32: torch.int32}


def _const(value: float, dtype, device):
    """A 0-dim ``dtype`` tensor on ``device`` holding ``value`` rounded to
    ``dtype``, as a weakly typed scalar is in JAX. Filled on the device (a
    ``torch.tensor`` from a Python number would be a host-to-card copy the
    card must wait for), and a tensor operand, so a CUDA division by it is
    the IEEE one, not a multiply by the reciprocal."""
    return torch.full((), value, dtype=dtype, device=device)


def uniform(key, shape, dtype, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` at ``dtype`` (bf16 or fp32): 1.x mantissas from
    the bits, minus one, scaled and clamped below by ``minval``, every
    operation at ``dtype``."""
    fi = torch.finfo(dtype)
    nbits, nmant = fi.bits, _nmant(dtype)
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape)
    one_bits = torch.tensor(1.0, dtype=dtype).view(_INT_OF_BITS[nbits]).item()
    fbits = (bits >> (rng_bits - nmant)) | one_bits
    floats = fbits.to(_INT_OF_BITS[nbits]).view(dtype) - torch.ones((), dtype=dtype,
                                                                     device=bits.device)
    lo = _const(minval, dtype, bits.device)
    hi = _const(maxval, dtype, bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# Cephes' logf coefficients, rounded to float32 as XLA holds them
_LOG_P = tuple(float(torch.tensor(c, dtype=torch.float32)) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))


def _log(x):
    """Natural log of positive fp32 ``x`` as XLA's CPU backend computes it
    (Cephes' ``logf``: exponent split at sqrt(1/2), a degree-8 polynomial in
    fused multiply-adds), in float32/float64 tensor ops that round the same
    on the CPU and the card. Equals XLA's result on all but ~0.03% of
    inputs, one ulp off there, where ``torch.log`` differs on ~23%."""
    f32, f64 = torch.float32, torch.float64
    x = torch.clamp_min(x.to(f32), torch.finfo(f32).tiny)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(f32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(f32)         # [0.5, 1)
    low = m < 0.707106781186547524
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(f32)

    def fma(a, b, c):
        return (a.to(f64) * b + c).to(f32)

    x2 = m * m
    x3 = x2 * m
    y = fma(fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = fma(fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = fma(fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = fma(fma(y, x3.to(f64), y1.to(f64)), x3.to(f64), y2.to(f64)) * x3
    y = y + e * -2.12194440e-4
    m = m - x2 * 0.5
    return (m + y) + e * 0.693359375


def gumbel(key, shape, dtype):
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform on
    [tiny, 1), each log XLA's (``_log``) rounded to ``dtype``."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny, maxval=1.0)
    return -_log(-_log(u).to(dtype)).to(dtype)


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis: one key (2,) for the
    whole (..., V) draw -> int64 (...)."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def categorical_rows(keys, logits):
    """One ``categorical`` a row: keys (R, 2), logits (R, V) -> (R,), as
    ``jax.vmap(categorical)`` draws."""
    g = gumbel(keys, (logits.shape[-1],), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


# ---------------------------------------------------------------------------
# temperature and top-p at the logits' dtype
# ---------------------------------------------------------------------------
def _cumsum(x, block: int = 16):
    """``jnp.cumsum`` over the last axis of (R, N) ``x`` as XLA's CPU
    backend runs it, every partial sum rounded to ``x``'s dtype: the
    reduce-window is rewritten as a blocked scan, an in-order scan inside
    each block of 16 (the last block zero-padded), the same scan over the
    block totals, and each block's exclusive prefix added to its scan."""
    R, N = x.shape
    if N <= block:
        acc, out = x[:, 0], [x[:, 0]]
        for j in range(1, N):
            acc = acc + x[:, j]
            out.append(acc)
        return torch.stack(out, dim=1)
    nb = -(-N // block)
    xp = torch.cat([x, x.new_zeros((R, nb * block - N))], dim=1)
    local = _cumsum(xp.reshape(R * nb, block), block).reshape(R, nb, block)
    tot = _cumsum(local[:, :, -1], block)
    pref = torch.cat([x.new_zeros((R, 1)), tot[:, :-1]], dim=1)
    return (local + pref[:, :, None]).reshape(R, nb * block)[:, :N]


def _filter_logits(logits, cfg: SamplerConfig):
    """Temperature + nucleus filtering at the logits' dtype (reference
    ``sampling.py:34``)."""
    dt = logits.dtype
    logits = logits / _const(cfg.temperature, dt, logits.device)
    if cfg.top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        # jax.nn.softmax as XLA runs it: exponentials of the rounded
        # differences, summed unrounded in fp32, each rounded for the divide
        d = (srt - srt[:, :1]).float()
        e = torch.exp(d)
        s = e.sum(dim=-1, keepdim=True).to(dt).float()
        probs = (e.to(dt).float() / s).to(dt)
        cum = _cumsum(probs)
        cut_idx = torch.sum(cum < _const(cfg.top_p, dt, cum.device), dim=-1, keepdim=True)
        V = srt.shape[-1]
        cutoff = torch.gather(srt, -1, cut_idx.clamp_max(V - 1))
        cutoff = torch.where(cut_idx < V, cutoff, torch.full_like(cutoff, float("nan")))
        logits = torch.where(logits >= cutoff, logits,
                             torch.full((), float("-inf"), dtype=dt, device=logits.device))
    return logits


def sample(logits, cfg: SamplerConfig, key=None):
    """logits (B, V) -> tokens (B,) int32. One key (2,) for the whole batch."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    key = torch.as_tensor(key, dtype=torch.int64).to(logits.device)
    return categorical(key, _filter_logits(logits, cfg)).to(torch.int32)


def sample_step(logits, cfg: SamplerConfig, keys=None):
    """Per-slot sampling: logits (B, V), keys (B, 2) -> (B,) int32, on the
    logits' device."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return categorical_rows(keys.to(logits.device), _filter_logits(logits, cfg)).to(torch.int32)


def sample_counted(logits, cfg: SamplerConfig, keys, counts):
    """Token ``counts[b]`` of each slot's request stream: ``sample_step``
    with ``step_keys(keys, counts)``; greedy folds no key."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_step(logits, cfg, step_keys(keys.to(logits.device), counts.to(logits.device)))
