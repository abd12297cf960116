"""The port's page fill and page completion (``core/paging.py`` through
``ops.fill_pages`` and ``ops.complete_page``, whose plain versions the CPU
runs) held against the reference's ``prefill_fill_pool`` and
``append_token`` on the CPU. Inputs come from numpy seeds; every state leaf
must be exactly equal: copies, min/max and the quantizer round nothing
differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.core import paging as jpaging
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.core import paging
from repro_torch.kernels import ops, ref

ARCH = "granite-3-8b-smoke"
SMALL = dict(method="freekv", page_size=8, budget=64, n_sink=8, n_window=8, tau=0.8)
# (kv_quant, quant_group_size): fp, int8 and int4, one scale a page half or
# one a group of 16 channels
QUANT = [("none", 0), ("int8", 0), ("int8", 16), ("int4", 0), ("int4", 16)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    """A leaf as numpy, bfloat16 widened to float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _states(kv_quant, group, B, max_len, state_dt, n_win=None):
    """The reference's and the port's empty states; with ``n_win`` both get
    a window ring of that many slots (a ring that is no whole number of
    pages, so a page can wrap its end)."""
    kw = dict(SMALL, kv_quant=kv_quant, quant_group_size=group)
    cfg = get_config(ARCH)
    tdt, jdt = DTYPES[state_dt]
    jst = jpaging.init_kv_state(jget_config(ARCH), JFreeKVConfig(**kw), B, max_len, jdt)
    st = paging.init_kv_state(cfg, FreeKVConfig(**kw), B, max_len, tdt, device="cpu")
    if n_win is not None:
        shape = (B, n_win, cfg.n_kv_heads, cfg.d_head)
        jst = dict(jst, win_k=jnp.zeros(shape, jdt), win_v=jnp.zeros(shape, jdt),
                   win_pos=jnp.full((B, n_win), -1, jnp.int32))
        st.update(win_k=torch.zeros(shape, dtype=tdt), win_v=torch.zeros(shape, dtype=tdt),
                  win_pos=torch.full((B, n_win), -1, dtype=torch.int32))
    return cfg, jst, st


def _pair(a, dt):
    """numpy float32 -> (jax, torch) arrays of dtype ``dt``, rounded alike."""
    tdt, jdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.array(a)).to(tdt)


def _assert_leaves_equal(st, jst):
    assert set(st) == set(jst)
    for key in jst:
        np.testing.assert_array_equal(_np(st[key]), _np(jst[key]), err_msg=key)


@pytest.mark.parametrize("kv_quant,group", QUANT)
@pytest.mark.parametrize("k_dt,state_dt", [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
def test_prefill_fill_pool_matches_reference(k_dt, state_dt, kv_quant, group):
    """``prefill_fill_pool`` through ``fill_pages`` on a prompt of 100 tokens
    (12 whole pages and 4 tokens past them), K and V in their own dtype and
    the state in its own: every leaf equal to the reference's."""
    cfg, jst, st = _states(kv_quant, group, 2, 160, state_dt)
    rng = np.random.default_rng(0)
    shape = (2, 100, cfg.n_kv_heads, cfg.d_head)
    jk, k = _pair(rng.standard_normal(shape).astype(np.float32), k_dt)
    jv, v = _pair(rng.standard_normal(shape).astype(np.float32), k_dt)
    k[0, 40:48] = 0                           # an all-zero page: scale 1 under int8/int4
    jk = jk.at[0, 40:48].set(0)
    v[0, 40:48] = 0
    jv = jv.at[0, 40:48].set(0)
    jst = jpaging.prefill_fill_pool(jst, jk, jv, jnp.full((2,), 100, jnp.int32))
    st = paging.prefill_fill_pool(st, k, v, 100)
    _assert_leaves_equal(st, jst)
    assert st["summ"][:, :12].abs().sum() > 0 and not st["summ"][:, 12:].any()


@pytest.mark.parametrize("kv_quant,group", QUANT)
@pytest.mark.parametrize("state_dt", ["f32", "bf16"])
def test_ragged_page_completion_matches_reference(state_dt, kv_quant, group):
    """Three rows at lengths 96, 91 and 88 over a 20-slot ring (2.5 pages of
    8), then 30 appends: on some steps no row completes a page, on some one
    row, on some two; page 12 (slots 16..19, 0..3) wraps the ring's end
    in every row. After every append every leaf equals the reference's
    masked ``append_token``."""
    cfg, jst, st = _states(kv_quant, group, 3, 160, state_dt, n_win=20)
    rng = np.random.default_rng(1)
    shape = (3, 96, cfg.n_kv_heads, cfg.d_head)
    jk, k = _pair(rng.standard_normal(shape).astype(np.float32), state_dt)
    jv, v = _pair(rng.standard_normal(shape).astype(np.float32), state_dt)
    lengths = np.array([96, 91, 88], np.int32)
    jst = jpaging.prefill_fill_pool(jst, jk, jv, jnp.asarray(lengths))
    st = paging.prefill_fill_pool(st, k, v, torch.from_numpy(lengths))
    completed = []
    for _ in range(30):
        jkn, kn = _pair(rng.standard_normal((3, cfg.n_kv_heads, cfg.d_head)).astype(np.float32),
                        state_dt)
        jvn, vn = _pair(rng.standard_normal((3, cfg.n_kv_heads, cfg.d_head)).astype(np.float32),
                        state_dt)
        jst = jpaging.append_token(jst, jkn, jvn)
        st = paging.append_token(st, kn, vn)
        _assert_leaves_equal(st, jst)
        completed.append([int(x) % 8 == 0 for x in st["length"]])
    assert {sum(c) for c in completed} == {0, 1, 2}
    assert (st["pool"][:, 12] != 0).flatten(1).any(dim=1).all()


@pytest.mark.parametrize("kv_quant,group", QUANT)
def test_complete_page_writes_only_completing_rows(kv_quant, group):
    """One ``complete_page`` where only row 1 completes a page: rows 0 and 2
    keep every byte of their pool, scales and summaries; row 1 changes at
    its completed page only, to what the reference's append wrote."""
    cfg, jst, st = _states(kv_quant, group, 3, 160, "f32", n_win=20)
    rng = np.random.default_rng(2)
    shape = (3, 96, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lengths = np.array([92, 103, 90], np.int32)         # row 1 completes page 12 next
    jst = jpaging.prefill_fill_pool(jst, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    st = paging.prefill_fill_pool(st, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(lengths))
    keys = [key for key in ("pool", "pool_scale", "summ") if key in st]
    before = {key: st[key].clone() for key in keys}
    kn = rng.standard_normal((3, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    jst = jpaging.append_token(jst, jnp.asarray(kn), jnp.asarray(vn))
    st = paging.append_token(st, torch.from_numpy(kn), torch.from_numpy(vn))
    _assert_leaves_equal(st, jst)
    for key in keys:
        assert torch.equal(st[key][[0, 2]], before[key][[0, 2]]), key
        changed = (st[key][1] != before[key][1]).flatten(1).any(dim=1)
        assert changed.nonzero().flatten().tolist() == [12], key


def test_complete_page_ref_gathers_a_wrapped_page():
    """The plain ``complete_page`` on a hand-built ring: the page's tokens are
    read at slots (page * p + t) % n_win, its summary is their min and max,
    its block their K and V halves in HND, and a row whose length is no
    whole number of pages (or whose page lies past the pool) writes nothing."""
    rng = np.random.default_rng(3)
    B, n_win, kv, d, p, n_pages = 3, 10, 2, 16, 4, 3
    win_k = torch.from_numpy(rng.standard_normal((B, n_win, kv, d)).astype(np.float32))
    win_v = torch.from_numpy(rng.standard_normal((B, n_win, kv, d)).astype(np.float32))
    summ = torch.zeros(B, n_pages, kv, 2, d)
    pool = torch.zeros(B, n_pages, kv, 2, p, d)
    length = torch.tensor([12, 13, 16], dtype=torch.int32)   # page 2 (slots 8, 9, 0, 1), none, past
    ref.complete_page_ref(win_k, win_v, length, summ, pool)
    toks = [(2 * p + t) % n_win for t in range(p)]
    pk, pv = win_k[0, toks], win_v[0, toks]                   # (p, kv, d)
    assert torch.equal(summ[0, 2], torch.stack([pk.amin(0), pk.amax(0)], dim=1))
    assert torch.equal(pool[0, 2], torch.stack([pk.transpose(0, 1), pv.transpose(0, 1)], dim=1))
    assert not summ[0, :2].any() and not pool[0, :2].any()
    assert not summ[1:].any() and not pool[1:].any()
    length = torch.tensor([20, 4, 4], dtype=torch.int32)      # page 4, past the pool; page 0
    ref.complete_page_ref(win_k, win_v, length, summ, pool)
    assert not pool[0, :2].any() and pool[1:, 0].flatten(1).any(dim=1).all()


def test_append_token_reads_no_host_lengths(monkeypatch):
    """``append_token`` takes no host lengths and reads nothing back: with
    ``Tensor.cpu``, ``tolist`` and ``item`` made to raise, a run of appends
    that completes pages still goes through (the plain path computes the
    mask as the kernel does, on the lengths' device)."""
    cfg, jst, st = _states("int8", 0, 2, 160, "f32")
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((2, 96, cfg.n_kv_heads, cfg.d_head))
                         .astype(np.float32))
    st = paging.prefill_fill_pool(st, k, k.flip(1).contiguous(), 96)

    def refuse(*a, **k):
        raise AssertionError("append_token read a tensor back")
    for name in ("cpu", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    kn = torch.zeros(2, cfg.n_kv_heads, cfg.d_head)
    for _ in range(9):
        st = paging.append_token(st, kn + 1, kn - 1)
    monkeypatch.undo()
    assert st["length"].tolist() == [105, 105]
    assert st["pool"][:, 12].abs().sum() > 0


@pytest.mark.parametrize("kv,d,itemsize,threads,want", [
    (8, 128, 2, 128, 4), (8, 128, 4, 128, 2), (8, 128, 2, 0, 1), (3, 64, 4, 128, 3),
    (6, 256, 4, 128, 1), (1, 16, 2, 128, 1), (32, 64, 2, 512, 32),
])
def test_fill_heads_per_block(kv, d, itemsize, threads, want):
    """The page-fill blocks' KV heads: the largest divisor of kv whose 2 * d *
    itemsize / 16 threads a head fit the target (at least one head), within
    the kernels' thread cap."""
    got = ops.fill_heads_per_block(kv, d, itemsize, threads)
    assert got == want and kv % got == 0
    assert got * 2 * d * itemsize // 16 <= max(threads, 2 * d * itemsize // 16)
    assert got * 2 * d * itemsize // 16 <= ops.FILL_MAX_THREADS


def test_fill_heads_per_block_refuses_wide_heads():
    with pytest.raises(ValueError, match="page-fill"):
        ops.fill_heads_per_block(1, 2048, 4, 128)
