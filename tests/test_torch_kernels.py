"""The port's plain kernel versions (``repro_torch.kernels.ref``, what
``repro_torch.kernels.ops`` runs on CPU tensors) against the reference's jnp
oracles and its Pallas kernels in interpret mode, at the sweep shapes of
``tests/test_kernels.py``. Inputs come from numpy; tolerances are
``test_kernels._tol``: 2e-5 at float32, 5e-2 at bfloat16, exact for gathers.

The CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

torch.set_float32_matmul_precision("highest")

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _pair(a, jdt, tdt):
    """The same values as a jnp array and a torch tensor of the given dtype."""
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,kv,G,N,p,d", [
    (1, 1, 1, 2, 8, 128), (2, 3, 4, 6, 32, 128), (1, 2, 8, 4, 16, 64),
    (3, 4, 2, 5, 32, 256),
])
def test_paged_attention_ref(B, kv, G, N, p, d, dt):
    name, jdt, tdt = dt
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, kv, G, d)), jdt, tdt)
    jk, tk = _pair(rng.standard_normal((B, kv, N, p, d)), jdt, tdt)
    jv, tv = _pair(rng.standard_normal((B, kv, N, p, d)), jdt, tdt)
    pos = rng.integers(-1, N * p, (B, kv, N, p)).astype(np.int32)
    cur = np.full((B,), N * p - 3, np.int32)        # some positions past cur
    scale = 1.0 / d ** 0.5
    o = ops.paged_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(cur),
                            scale=scale)
    assert o.dtype == tdt and o.shape == (B, kv, G, d)
    o_ref = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur), scale)
    o_pallas = jops.paged_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur),
                                    scale=scale, interpret=True)
    np.testing.assert_allclose(_np(o), _np(o_ref), **_tol(name))
    np.testing.assert_allclose(_np(o), _np(o_pallas), **_tol(name))


def test_paged_attention_ref_softcap():
    B, kv, G, N, p, d = 2, 2, 2, 4, 16, 128
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, kv, G, d), (B, kv, N, p, d), (B, kv, N, p, d)))
    pos = rng.integers(-1, 60, (B, kv, N, p)).astype(np.int32)
    cur = np.full((B,), 64, np.int32)
    o = ref.paged_attention_ref(*map(torch.from_numpy, (q, k, v, pos, cur)), 0.1,
                                softcap=20.0)
    o_ref = jref.paged_attention_ref(*map(jnp.asarray, (q, k, v, pos, cur)), 0.1,
                                     softcap=20.0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5)


def test_paged_attention_ref_all_masked_partition():
    """A page set whose every lane is masked gets the reference's uniform
    weights (softmax over -1e30), and a masked page next to valid ones adds
    nothing: exp(-1e30 - m) == 0 (the sentinels are -1e30, never -inf)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 1, 2, 32)).astype(np.float32)
    k = rng.standard_normal((1, 1, 3, 8, 32)).astype(np.float32)
    v = rng.standard_normal((1, 1, 3, 8, 32)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32).reshape(1, 1, 3, 8)
    pos[:, :, 1] = -1
    cur = np.array([23], np.int32)
    o = ref.paged_attention_ref(*map(torch.from_numpy, (q, k, v, pos, cur)), 0.2)
    keep = [0, 2]
    o_sub = ref.paged_attention_ref(*map(torch.from_numpy, (
        q, k[:, :, keep].copy(), v[:, :, keep].copy(), pos[:, :, keep].copy(), cur)), 0.2)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), o_sub.numpy(), atol=2e-6)
    none = np.full_like(pos, -1)
    o_none = ref.paged_attention_ref(*map(torch.from_numpy, (q, k, v, none, cur)), 0.2)
    np.testing.assert_allclose(o_none.numpy()[0, 0],
                               np.broadcast_to(v.reshape(24, 32).mean(0), (2, 32)),
                               atol=2e-6)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,kv,G,d,N", [
    (1, 1, 1, 128, 4), (2, 3, 4, 128, 8), (2, 2, 5, 64, 256),
])
def test_page_scores_ref(B, kv, G, d, N, dt):
    name, jdt, tdt = dt
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((B, N, kv, 2, d))
    summ = np.stack([raw.min(axis=3), raw.max(axis=3)], axis=3)
    jq, tq = _pair(rng.standard_normal((B, kv, G, d)), jdt, tdt)
    js, ts = _pair(summ, jdt, tdt)
    s = ops.page_scores(tq, ts, scale=0.088)
    assert s.dtype == torch.float32 and s.shape == (B, kv, G, N)
    np.testing.assert_allclose(s.numpy(), _np(jref.page_scores_ref(jq, js, 0.088)),
                               **_tol(name))
    np.testing.assert_allclose(s.numpy(), _np(jops.page_scores(jq, js, scale=0.088,
                                                               interpret=True)),
                               **_tol(name))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,n_pages,kv,p,d,n_sel", [
    (1, 4, 1, 8, 128, 2), (2, 16, 3, 32, 128, 5), (2, 8, 2, 16, 64, 8),
])
def test_recall_gather_ref(B, n_pages, kv, p, d, n_sel, dt):
    name, jdt, tdt = dt
    rng = np.random.default_rng(4)
    jpool, tpool = _pair(rng.standard_normal((B, n_pages, kv, 2, p, d)), jdt, tdt)
    idx = rng.integers(-1, n_pages, (B, kv, n_sel)).astype(np.int32)
    idx[0, 0, 0] = -1
    k, v = ops.recall_gather(tpool, torch.from_numpy(idx))
    assert k.dtype == tdt and k.shape == (B, kv, n_sel, p, d)
    wants = [jref.recall_gather_ref(jpool, jnp.asarray(idx))]
    if name == "float32":       # a byte copy: one dtype suffices for the slow interpreter
        wants.append(jops.recall_gather(jpool, jnp.asarray(idx), interpret=True))
    for jk_, jv_ in wants:
        np.testing.assert_array_equal(_np(k), _np(jk_))
        np.testing.assert_array_equal(_np(v), _np(jv_))
    assert not k[0, 0, 0].any() and not v[0, 0, 0].any()


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,T,kv,d,p", [
    (1, 64, 1, 128, 8), (2, 128, 3, 128, 32), (2, 96, 2, 64, 16),
])
def test_page_summary_ref(B, T, kv, d, p, dt):
    """Exact against the reference's oracle and its Pallas kernel in
    interpret mode (``test_kernels.py::test_page_summary_sweep`` shapes)."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(6)
    jk, tk = _pair(rng.standard_normal((B, T, kv, d)), jdt, tdt)
    s = ops.page_summary(tk, page_size=p)
    assert s.dtype == tdt and s.shape == (B, T // p, kv, 2, d)
    np.testing.assert_array_equal(_np(s), _np(jref.page_summary_ref(
        jk.reshape(B, T // p, p, kv, d))))
    np.testing.assert_array_equal(_np(s), _np(jops.page_summary(jk, page_size=p,
                                                                interpret=True)))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,H,kv,T,d,blk,window", [
    (1, 2, 1, 128, 128, 64, None), (2, 6, 3, 256, 64, 128, None),
    (1, 4, 4, 128, 128, 128, None), (1, 2, 2, 256, 64, 64, 64),
])
def test_flash_prefill_ref(B, H, kv, T, d, blk, window, dt):
    """Causal, and causal with a sliding window, against the reference's
    oracle and its Pallas kernel in interpret mode
    (``test_kernels.py::test_flash_prefill_sweep`` and ``_window`` shapes)."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng.standard_normal((B, H, T, d)), jdt, tdt)
    jk, tk = _pair(rng.standard_normal((B, kv, T, d)), jdt, tdt)
    jv, tv = _pair(rng.standard_normal((B, kv, T, d)), jdt, tdt)
    scale = 1.0 / d ** 0.5
    o = ops.flash_prefill(tq, tk, tv, scale=scale, causal=True, window=window)
    assert o.dtype == tdt and o.shape == (B, H, T, d)
    np.testing.assert_allclose(_np(o), _np(jref.flash_prefill_ref(jq, jk, jv, scale,
                                                                  window=window)),
                               **_tol(name))
    np.testing.assert_allclose(_np(o), _np(jops.flash_prefill(jq, jk, jv, scale=scale,
                                                              window=window, blq=blk,
                                                              blk=blk, interpret=True)),
                               **_tol(name))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,H,kv,T,d,blk", [(1, 6, 6, 192, 64, 64), (2, 4, 2, 128, 128, 64)])
def test_flash_prefill_ref_bidirectional(B, H, kv, T, d, blk, dt):
    """``causal=False``, the encoder's form (whisper: H = kv, d 64): every
    query sees every key, against the reference's oracle and its Pallas
    kernel in interpret mode."""
    name, jdt, tdt = dt
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng.standard_normal((B, H, T, d)), jdt, tdt)
    jk, tk = _pair(rng.standard_normal((B, kv, T, d)), jdt, tdt)
    jv, tv = _pair(rng.standard_normal((B, kv, T, d)), jdt, tdt)
    scale = 1.0 / d ** 0.5
    o = ops.flash_prefill(tq, tk, tv, scale=scale, causal=False)
    assert o.dtype == tdt and o.shape == (B, H, T, d)
    np.testing.assert_allclose(_np(o), _np(jref.flash_prefill_ref(jq, jk, jv, scale,
                                                                  causal=False)),
                               **_tol(name))
    np.testing.assert_allclose(_np(o), _np(jops.flash_prefill(jq, jk, jv, scale=scale,
                                                              causal=False, blq=blk, blk=blk,
                                                              interpret=True)),
                               **_tol(name))
    # the first query row sees the last key: not the causal result
    causal = ops.flash_prefill(tq, tk, tv, scale=scale, causal=True)
    assert not torch.allclose(o[:, :, 0].float(), causal[:, :, 0].float())


@pytest.mark.parametrize("window", [None, 48])
def test_flash_prefill_ref_softcap(window):
    """The reference's oracle has no softcap; its model's ``attention_dense``
    does (capped scores, then the causal and window mask): the port's plain
    flash_prefill equals it at float32, on a T that is no multiple of 64."""
    from repro.configs import get_config as jget_config
    from repro.models import attention as jattention
    import dataclasses
    cfg = dataclasses.replace(jget_config("granite-3-8b-smoke"), attn_logit_softcap=20.0)
    B, T, H, kv, d = 2, 70, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, d), (B, T, kv, d), (B, T, kv, d)))
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))
    want = jattention.attention_dense(cfg, *map(jnp.asarray, (q, k, v)), pos, pos,
                                      causal=True, window=window)
    scale = 1.0 / d ** 0.5
    o = ops.flash_prefill(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                          scale=scale, causal=True, window=window, softcap=20.0)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors take the plain versions; only a kernel launch counts."""
    ops.reset_launches()
    q = torch.randn(1, 1, 2, 16)
    kp = torch.randn(1, 1, 2, 8, 16)
    pos = torch.arange(16, dtype=torch.int32).reshape(1, 1, 2, 8)
    ops.paged_attention(q, kp, kp, pos, torch.tensor([15], dtype=torch.int32), scale=0.25)
    ops.page_scores(q, torch.randn(1, 3, 1, 2, 16), scale=0.25)
    ops.recall_gather(torch.randn(1, 3, 1, 2, 8, 16), torch.zeros((1, 1, 2), dtype=torch.int32))
    ops.recall_gather_quant(torch.zeros((1, 3, 1, 2, 8, 16), dtype=torch.int8),
                            torch.ones((1, 3, 1, 2, 1)), torch.zeros((1, 1, 2), dtype=torch.int32),
                            bits=8)
    ops.page_summary(torch.randn(1, 16, 1, 16), page_size=8)
    ops.flash_prefill(q, q, q, scale=0.25)
    ops.recall_values(torch.randn(1, 3, 1, 2, 8, 16), torch.zeros((1, 1, 2), dtype=torch.int32))
    ops.recall_values_quant(torch.zeros((1, 3, 1, 2, 8, 16), dtype=torch.int8),
                            torch.ones((1, 3, 1, 2, 1)), torch.zeros((1, 1, 2), dtype=torch.int32),
                            bits=8)
    ops.centroid_scores(q, torch.randn(1, 4, 1, 2, 16), torch.ones((1, 4, 1), dtype=torch.int32),
                        scale=0.25)
    length = torch.tensor([24], dtype=torch.int32)
    ops.select_pages(q, torch.randn(1, 3, 1, 2, 16), length, n_sel=2, scale=0.25, page_size=8,
                     n_sink=0, n_window=0)
    ops.centroid_candidates(q, torch.randn(1, 4, 1, 2, 16), torch.ones((1, 4, 1), dtype=torch.int32),
                            torch.zeros((1, 3, 1), dtype=torch.int32), length, m=2, scale=0.25,
                            page_size=8, n_sink=0, n_window=0)
    ops.fill_pages(torch.randn(1, 16, 1, 16), torch.randn(1, 16, 1, 16), torch.zeros(1, 2, 1, 2, 16),
                   torch.zeros(1, 2, 1, 2, 8, 16))
    ops.complete_page(torch.randn(1, 24, 1, 16), torch.randn(1, 24, 1, 16),
                      torch.tensor([16], dtype=torch.int32), torch.zeros(1, 4, 1, 2, 16),
                      torch.zeros(1, 4, 1, 2, 8, 16))
    ops.paged_attention_lse(q, kp, kp, pos, torch.tensor([15], dtype=torch.int32), scale=0.25)
    ops.select_pages_shard(q, torch.randn(1, 3, 1, 2, 16), length, page_lo=1, n_sel=2,
                           scale=0.25, page_size=8, n_sink=0, n_window=0)
    ops.complete_page_shard(torch.randn(1, 24, 1, 16), torch.randn(1, 24, 1, 16),
                            torch.tensor([16], dtype=torch.int32), torch.zeros(1, 2, 1, 2, 16),
                            torch.zeros(1, 2, 1, 2, 8, 16), page_lo=1)
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)


@pytest.mark.parametrize("sms", [1, 8, 108, 132])
@pytest.mark.parametrize("rows", [1, 4, 32, 128, 4096])
def test_split_pages_covers_every_page_once(rows, sms):
    """``ops.split_pages`` (a pure function of N, B * kv and the SM count):
    the slices of ``split_range`` tile [0, N) in order with no gap or
    overlap, there are at most MAX_SPLIT of them, and each holds at least
    MIN_PAGES_PER_SPLIT pages (all N when N is fewer)."""
    for N in list(range(1, 80)) + [259, 1000, 5000]:
        n_split = ops.split_pages(N, rows, sms)
        assert 1 <= n_split <= min(ops.MAX_SPLIT, N)
        bounds = [ops.split_range(N, n_split, s) for s in range(n_split)]
        assert bounds[0][0] == 0 and bounds[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert min(n1 - n0 for n0, n1 in bounds) >= min(N, ops.MIN_PAGES_PER_SPLIT)


def test_split_pages_main_path_shape():
    """At the main path's decode (B * kv = 32 rows, 65 pages, 132 SMs) the
    page axis goes into 16 slices of 4 or 5 pages: 512 blocks, one wave at
    four per SM."""
    n_split = ops.split_pages(65, 32, 132)
    assert n_split == 16
    assert {n1 - n0 for n0, n1 in (ops.split_range(65, 16, s) for s in range(16))} == {4, 5}


@pytest.mark.parametrize("N,p,rows,masked", [
    (1, 8, 1, None), (3, 16, 4, None), (9, 32, 32, 1), (65, 32, 32, 0), (23, 64, 2, 2),
])
def test_split_merge_equals_plain(N, p, rows, masked):
    """The CUDA kernel's arithmetic on the CPU: per-slice online-softmax
    partials over ``split_range`` and their log-sum-exp merge equal
    ``paged_attention_ref``, with slice ``masked`` wholly masked (its m stays
    -1e30 and drops out of the merge)."""
    rng = np.random.default_rng(7)
    B, kv, G, d = 1, 2, 4, 16
    q = torch.from_numpy(rng.standard_normal((B, kv, G, d), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, kv, N, p, d), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, kv, N, p, d), dtype=np.float32))
    pos = torch.from_numpy(rng.integers(-1, N * p, (B, kv, N, p)).astype(np.int32))
    cur = torch.tensor([N * p - 3], dtype=torch.int32)
    n_split = ops.split_pages(N, rows, 132)
    if masked is not None:
        masked = min(masked, n_split - 1)
        n0, n1 = ops.split_range(N, n_split, masked)
        pos[:, :, n0:n1] = -1
    want = ref.paged_attention_ref(q, k, v, pos, cur, 0.25)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        n0, n1 = ops.split_range(N, n_split, s)
        sc = torch.einsum("bkgd,bkld->bkgl", q, k[:, :, n0:n1].reshape(B, kv, -1, d)) * 0.25
        ok = (pos[:, :, n0:n1].reshape(B, kv, 1, -1) >= 0) & \
             (pos[:, :, n0:n1].reshape(B, kv, 1, -1) <= cur[:, None, None, None])
        sc = torch.where(ok, sc, torch.full((), -1e30))
        m = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m)
        ms.append(m)
        ls.append(e.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgl,bkld->bkgd", e, v[:, :, n0:n1].reshape(B, kv, -1, d)))
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    L = sum(wi * li for wi, li in zip(w, ls)).clamp_min(1e-30)
    got = sum(wi * ai for wi, ai in zip(w, accs)) / L
    if masked is not None and n_split > 1:
        assert float(ms[masked].max()) == float(np.float32(-1e30))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_kernel_ablation_edits_match_sources():
    """Every edit of ``launch/kernel_ablation.py``'s variants (the attention
    kernels' and the two gathers') still finds its text in the kernel
    sources, exactly once, so the ablation keeps measuring the kernels as
    they are; every gather variant names a build its sources have."""
    from repro_torch.kernels import build
    from repro_torch.launch import kernel_ablation as ka
    common = (build.CSRC / "common.cuh").read_text()
    for name, variants in (("flash_prefill", ka.FLASH_VARIANTS),
                           ("paged_attention", {k: v[0] for k, v in ka.PAGED_VARIANTS.items()}),
                           *ka.GATHER_BUILDS.items()):
        src = (build.CSRC / f"{name}.cu").read_text()
        for vname, edits in variants.items():
            for old, _ in edits:
                assert src.count(old) + common.count(old) == 1, (name, vname, old)
    for vname, (bname, grid_sms) in ka.GATHER_VARIANTS.items():
        assert bname in ka.GATHER_BUILDS["recall_gather"], vname
        assert grid_sms is None or 1 <= grid_sms <= ops.HOST_GATHER_SMS, vname
    assert {n for _, n in ka.GATHER_VARIANTS.values()} >= {8, 16, 32, None}
    assert ka.variant_grid(1792, 132, 2, 32) == ops.gather_grid(1792, 132, 2, True)
    assert ka.variant_grid(1792, 132, 2, None) == ops.gather_grid(1792, 132, 2, False)


def test_p_split_emulation_keeps_flash_prefill_within_tol():
    """The bf16 flash_prefill's P @ V, emulated in float32 on the CPU
    (``launch/p_split_emulation.py``): P split into bfloat16 hi + lo keeps
    every output within chip_smoke's bfloat16 TOL of the plain version,
    while a single bfloat16 P does not, which is why the kernel pays for the
    second product."""
    from repro_torch.launch.p_split_emulation import run
    res = run(t=256, heads=2)
    assert res["hi+lo"][0] == 0
    assert res["bf16"][0] > 0


@pytest.mark.parametrize("host", [True, False], ids=["host_pool", "device_pool"])
@pytest.mark.parametrize("B,kv,n_sel", [(4, 8, 56), (1, 1, 1), (3, 5, 7), (2, 3, 57),
                                        (1, 8, 1), (5, 7, 113)])
@pytest.mark.parametrize("sms,blocks_per_sm", [(132, 2), (132, 1), (8, 3), (1, 4)])
def test_gather_grid_walks_every_item_once(B, kv, n_sel, host, sms, blocks_per_sm):
    """``ops.gather_grid`` and ``ops.gather_items`` (pure functions, as the
    gathers' ``walk_items`` partitions its work): every unit (the K and V
    halves of each (b, kv, lane) item, or the V halves alone) goes to
    exactly one block of the grid; from a host pool the grid is what
    HOST_GATHER_SMS SMs hold, from a device pool what the card holds, and
    never more blocks than the units fill."""
    for halves in (1, 2):
        n = halves * B * kv * n_sel
        nb = ops.gather_grid(n, sms, blocks_per_sm, host)
        seen = sorted(i for b in range(nb) for i in ops.gather_items(n, nb, b))
        assert seen == list(range(n))
        cap_sms = min(ops.HOST_GATHER_SMS, sms) if host else sms
        assert 1 <= nb <= min(cap_sms * blocks_per_sm, -(-n // ops.GATHER_WARPS))
        if host:
            assert nb <= ops.HOST_GATHER_SMS * blocks_per_sm


def test_gather_grid_main_path_shape():
    """At the main path's gather (4 x 8 x 56 = 1792 items, 3584 K and V
    halves; 132 SMs, two blocks an SM): a pinned host pool takes
    HOST_GATHER_SMS (32) SMs' worth of blocks; a device pool the card's 264
    for K+V, and for the V halves alone as many as they fill (1792 / 8 warps
    = 224); bad card numbers are refused."""
    assert ops.HOST_GATHER_SMS == 32
    assert ops.gather_grid(2 * 1792, 132, 2, True) == 64
    assert ops.gather_grid(1792, 132, 2, True) == 64
    assert ops.gather_grid(2 * 1792, 132, 1, True) == 32
    assert ops.gather_grid(2 * 1792, 132, 2, False) == 264
    assert ops.gather_grid(1792, 132, 2, False) == 224
    assert ops.gather_grid(1792, 16, 2, True) == 32          # a card smaller than the cap
    with pytest.raises(ValueError):
        ops.gather_grid(1792, 132, 0, True)


@pytest.mark.parametrize("n_blocks", [1, 3, 40, 64])
def test_gather_walk_equals_plain(n_blocks):
    """The fp gather kernels' walk on the CPU: each block's warps copy each
    valid unit's half of the clamped (2, p, d) block (unit -> item and half,
    item -> request, KV head) and write zeros for the units of -1 items;
    together they give ``recall_gather_ref``'s k and v, and the V-only walk
    ``recall_values_ref``'s v, exactly, each output half written once."""
    rng = np.random.default_rng(11)
    B, n_pages, kv, p, d, n_sel = 3, 9, 5, 4, 8, 7
    pool = torch.from_numpy(rng.standard_normal((B, n_pages, kv, 2, p, d), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(-2, n_pages + 3, (B, kv, n_sel)).astype(np.int32))
    flat_pool = pool.reshape(-1, 2, p, d)            # blocks in (b, page, h) order
    flat_idx = idx.reshape(-1).tolist()
    for halves in (2, 1):
        out = torch.full((2, idx.numel(), p, d), float("nan"))   # K, V
        written = [0] * (halves * idx.numel())
        n_units = halves * idx.numel()
        for blk in range(n_blocks):
            for unit in ops.gather_items(n_units, n_blocks, blk):
                item, half = unit // halves, (unit % 2 if halves == 2 else 1)
                page = flat_idx[item]
                if page >= 0:
                    bh = item // n_sel
                    blk_ = ((bh // kv) * n_pages + min(page, n_pages - 1)) * kv + bh % kv
                    out[half, item] = flat_pool[blk_, half]
                else:
                    out[half, item] = 0.0
                written[unit] += 1
        assert written == [1] * n_units
        want_k, want_v = ref.recall_gather_ref(pool, idx)
        assert torch.equal(out[1].reshape(want_v.shape), want_v)
        if halves == 2:
            assert torch.equal(out[0].reshape(want_k.shape), want_k)
        else:
            assert torch.equal(out[1].reshape(want_v.shape), ref.recall_values_ref(pool, idx))


@pytest.mark.parametrize("d,bits", [(64, 8), (128, 8), (96, 8), (256, 4), (128, 4), (64, 4)])
def test_quant_chunk_scale_index(d, bits):
    """The quantized gather's scale index, tracked across a 16-byte chunk's
    channels with one divide a chunk (``chunk_scales`` in
    csrc/recall_gather_quant.cu), equals ``c // g`` for every channel of
    every chunk, for every group count that divides d."""
    def chunk_scales(c, g):
        gi, nxt, out = c // g, (c // g + 1) * g, []
        for j in range(16):
            if c + j == nxt:
                gi, nxt = gi + 1, nxt + g
            out.append(gi)
        return out

    dp = d * bits // 8
    for n_g in [n for n in range(1, min(d, 256) + 1) if d % n == 0]:
        g = d // n_g
        for c0 in range(0, dp, 16):
            firsts = [c0] if bits == 8 else [c0, c0 + d // 2]
            for c in firsts:
                assert chunk_scales(c, g) == [(c + j) // g for j in range(16)], (n_g, c)
