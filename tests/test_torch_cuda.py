"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a card. On a machine with an H100 (this file imports no JAX,
so the repo's conftest can be left out there):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _tol(dtype):
    """Kernel against its plain version, by output dtype: both compute in
    float32, so a bfloat16 output may differ by a bf16 step or two (rtol
    2**-6), never by more; float32 outputs only by summation order."""
    return dict(atol=1e-4, rtol=2 ** -6) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_kernels_match_plain(dtype):
    """On the card: every kernel against its plain version, exact for the
    gather, ``_tol`` for the rest."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    dev = torch.device("cuda", 0)
    tol = _tol(dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    B, kv, G, N, p, d = 2, 3, 4, 7, 32, 128
    q = torch.randn(B, kv, G, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, kv, N, p, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, kv, N, p, d, generator=g, device=dev).to(dtype)
    pos = torch.randint(-1, N * p, (B, kv, N, p), generator=g, device=dev, dtype=torch.int32)
    cur = torch.full((B,), N * p - 5, dtype=torch.int32, device=dev)
    o = ops.paged_attention(q, k, v, pos, cur, scale=0.09)
    torch.testing.assert_close(o.float(), ref.paged_attention_ref(q, k, v, pos, cur, 0.09).float(),
                               **tol)
    summ = torch.sort(torch.randn(B, 40, kv, 2, d, generator=g, device=dev), dim=3).values
    summ = summ.to(dtype)
    torch.testing.assert_close(ops.page_scores(q, summ, scale=0.09),
                               ref.page_scores_ref(q, summ, 0.09), **_tol(torch.float32))
    pool = torch.randn(B, 40, kv, 2, p, d, generator=g, device=dev).to(dtype)
    idx = torch.randint(-1, 40, (B, kv, 9), generator=g, device=dev, dtype=torch.int32)
    for src in (pool, pool.cpu().pin_memory()):
        got = ops.recall_gather(src, idx)
        want = ref.recall_gather_ref(pool, idx)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_host_pool_resolved_once(monkeypatch):
    """A pinned host pool's mapped address is looked up on its first gather
    only, and no launch changes the current device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    pool = torch.randn(1, 5, 2, 2, 8, 64).to(torch.bfloat16).pin_memory()
    idx = torch.tensor([[[0, 4, -1], [2, 2, 1]]], dtype=torch.int32, device=dev)
    calls = []
    real = ops.device_pointer
    monkeypatch.setattr(ops, "device_pointer", lambda t, d: calls.append(1) or real(t, d))
    before = torch.cuda.current_device()
    for _ in range(3):
        got = ops.recall_gather(pool, idx)
    assert len(calls) == 1 and torch.cuda.current_device() == before
    for a, b in zip(got, ref.recall_gather_ref(pool.to(dev), idx)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_staged_recall_bit_exact():
    """The staged recall on the side stream, from a pinned host pool: the
    next step's buffer equals a fresh recall and the buffer attention reads
    equals where(corr, fresh, stale), bit for bit, as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.core.recall_pipeline import RecallExecutor, wait_staged
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    B, n_pages, kv, p, d, n_sel = 2, 40, 3, 32, 128, 6
    pool = torch.randn(B, n_pages, kv, 2, p, d, generator=g).to(torch.bfloat16)
    prev_idx = torch.stack([torch.randperm(n_pages, generator=g)[:n_sel]
                            for _ in range(B * kv)]).reshape(B, kv, n_sel).int()
    new_idx = prev_idx.clone()
    new_idx[..., :3] = torch.randint(0, n_pages, (B, kv, 3), generator=g).int()
    new_idx[0, 0, -1] = -1
    need = torch.rand(B, kv, generator=g) < 0.5
    need[0, 0], need[0, 1] = True, False
    ex = RecallExecutor(recall_fn=ops.recall_gather)
    want = ex.step(pool, new_idx, prev_idx, *ops.recall_gather(pool, prev_idx), need)
    pinned = pool.pin_memory()
    prev_k, prev_v = ops.recall_gather(pinned, prev_idx.to(dev))
    got = ex.step(pinned, new_idx.to(dev), prev_idx.to(dev), prev_k, prev_v, need.to(dev))
    state = {"sel_k": got.staged_k, "sel_ready": got.ready}
    wait_staged(state)
    for name in ("use_k", "use_v", "use_idx", "staged_k", "staged_v",
                 "topup_blocks", "staged_blocks", "reused_blocks"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,kv,G,N,p,d", [
    (1, 1, 1, 2, 8, 128), (2, 3, 4, 6, 32, 128), (1, 2, 8, 4, 16, 64),
    (3, 4, 2, 5, 32, 256), (1, 2, 4, 9, 64, 256),
    (2, 2, 1, 1, 32, 128), (1, 3, 4, 2, 32, 128), (1, 2, 4, 23, 16, 128),
    (1, 1, 16, 12, 8, 64), (2, 2, 8, 17, 64, 128), (1, 2, 16, 40, 16, 256),
    (4, 8, 4, 65, 32, 128),
])
def test_cuda_paged_attention_sweep(B, kv, G, N, p, d, dtype):
    """The ``tests/test_kernels.py`` sweep shapes, one whose pages need
    more than 48 KB of shared memory (p=64, d=256), and the edges of the
    split and its ring: N = 1, N below the ring's four stages, N that is no
    multiple of a slice, G up to 16, p from 8 to 64, the main path's shape.
    Where the pages are cut into several slices, one slice is wholly
    masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, kv, G, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, kv, N, p, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, kv, N, p, d, generator=g, device=dev).to(dtype)
    pos = torch.randint(-1, N * p, (B, kv, N, p), generator=g, device=dev, dtype=torch.int32)
    cur = torch.full((B,), N * p - 2, dtype=torch.int32, device=dev)
    n_split = ops.split_pages(N, B * kv, torch.cuda.get_device_properties(dev).multi_processor_count)
    if n_split > 1:
        n0, n1 = ops.split_range(N, n_split, n_split // 2)
        pos[:, :, n0:n1] = -1
    for softcap in (None, 20.0):
        got = ops.paged_attention(q, k, v, pos, cur, scale=d ** -0.5, softcap=softcap)
        want = ref.paged_attention_ref(q, k, v, pos, cur, d ** -0.5, softcap)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_page_summary_and_quant_gather_exact(dtype):
    """page_summary equal to its plain version (also on a prefix of longer
    rows, as prefill passes it), and recall_gather_quant at int8 and int4
    equal to its plain version from a device pool and a pinned host pool,
    with -1 and -2 lanes, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.quant.quantizers import quantize_block
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    for T, extra, p, kv, d in ((96, 8, 8, 2, 64), (64, 0, 32, 3, 128), (32, 0, 32, 1, 256)):
        k = torch.randn(2, T + extra, kv, d, generator=g, device=dev).to(dtype)[:, :T]
        assert torch.equal(ops.page_summary(k, page_size=p), ref.page_summary_ref(k, p))
    for bits, group, d in ((8, 0, 128), (4, 0, 128), (8, 16, 64), (4, 8, 64)):
        pool_f = torch.randn(2, 12, 3, 2, 8, d, generator=g, device=dev)
        pool_f[:, 1] = 0
        pool, sc = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, 12, (2, 3, 5), generator=g, device=dev, dtype=torch.int32)
        want = ref.recall_gather_quant_ref(pool, sc, idx, bits, dtype)
        for src, ssrc in ((pool, sc), (pool.cpu().pin_memory(), sc.cpu().pin_memory())):
            got = ops.recall_gather_quant(src, ssrc, idx, bits=bits, out_dtype=dtype)
            for a, b in zip(got, want):
                assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,H,kv,T,d,window,softcap", [
    (1, 2, 1, 128, 128, None, None), (2, 6, 3, 256, 64, None, None),
    (1, 4, 4, 200, 128, None, None), (1, 2, 2, 256, 64, 64, None),
    (2, 4, 2, 77, 64, None, 20.0), (1, 2, 1, 130, 256, 50, 30.0),
    (1, 8, 2, 1000, 128, 300, 30.0),
    (1, 4, 4, 1, 128, None, None), (1, 4, 1, 63, 64, None, None),
    (1, 8, 1, 65, 128, None, None), (2, 4, 1, 127, 64, None, None),
    (1, 8, 1, 129, 64, None, None), (1, 2, 2, 300, 128, None, None),
    (1, 8, 1, 200, 64, None, None), (1, 8, 2, 700, 128, 100, None),
    (1, 4, 1, 333, 64, 77, 25.0), (2, 32, 8, 2048, 128, None, None),
])
def test_cuda_flash_prefill_matches_plain(B, H, kv, T, d, window, softcap, dtype):
    """flash_prefill against its plain version on the model's strided
    (B, T, heads, d) views: T with and without a partial last block (T = 1,
    63, 65, 127, 129, 200, 300: around the 64-key tile and the 128-row query
    block), G = 1, 4 and 8 at d 64 and 128, windows whose first key falls
    inside a key tile, and the main path's widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(B, T, n, d, generator=g, device=dev).to(dtype).transpose(1, 2)
               for n in (H, kv, kv))
    got = ops.flash_prefill(q, k, v, scale=d ** -0.5, window=window, softcap=softcap)
    want = ref.flash_prefill_ref(q, k, v, d ** -0.5, True, window, softcap)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,H,kv,Tq,Tk,d,window,softcap", [
    (1, 8, 2, 100, 300, 128, None, None), (1, 4, 1, 1, 513, 64, None, None),
    (2, 4, 2, 200, 777, 64, None, 20.0), (1, 8, 2, 300, 1000, 128, 256, None),
    (1, 2, 1, 130, 700, 256, 50, 30.0), (1, 8, 1, 64, 96, 64, None, None),
    (1, 8, 2, 129, 161, 128, 40, None), (1, 32, 8, 1000, 7200, 128, None, None),
])
def test_cuda_flash_prefill_extension_matches_plain(B, H, kv, Tq, Tk, d, window, softcap,
                                                    dtype):
    """flash_prefill with Tq < Tk (query row i at position Tk - Tq + i, the
    causal mask aligned bottom-right) against its plain version on the
    model's strided views: offsets that are no multiple of the 64-key tile
    or the 128-row query block, a single query row, windows, softcaps, the
    FMA path (float32, d 256) and the wgmma path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, Tq, H, d, generator=g, device=dev).to(dtype).transpose(1, 2)
    k, v = (torch.randn(B, Tk, kv, d, generator=g, device=dev).to(dtype).transpose(1, 2)
            for _ in range(2))
    got = ops.flash_prefill(q, k, v, scale=d ** -0.5, window=window, softcap=softcap)
    want = ref.flash_prefill_ref(q, k, v, d ** -0.5, True, window, softcap)
    assert got.shape == q.shape and got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("off,window", [(32, None), (100, None), (1000, None), (288, 200)])
def test_cuda_flash_prefill_extension_rows_equal_whole(dtype, off, window):
    """The last Tq rows of a whole prompt and the same rows as an extension
    over all its keys: bit for bit on the float32 FMA path (key blocks are
    aligned to key 0 and a wholly masked block leaves a row unchanged, so a
    row does not depend on where its chunk began); within TOL on the bf16
    wgmma path, whose unmasked fast path depends on the query tile's
    alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    T, d = 1300, 128
    q, k, v = (torch.randn(1, T, n, d, generator=g, device=dev).to(dtype).transpose(1, 2)
               for n in (8, 2, 2))
    whole = ops.flash_prefill(q, k, v, scale=d ** -0.5, window=window)
    ext = ops.flash_prefill(q[:, :, off:], k, v, scale=d ** -0.5, window=window)
    if dtype == torch.float32:
        assert torch.equal(ext, whole[:, :, off:])
    else:
        torch.testing.assert_close(ext.float(), whole[:, :, off:].float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_values_only_gathers_and_centroid_scores(dtype):
    """recall_values and recall_values_quant (int8 and int4, groups 0, 16
    and 32) equal to their plain versions bit for bit from a device pool and
    a pinned host pool, with -1 and -2 lanes; centroid_scores within 2e-5
    (a float32 output, held as page_scores), empty clusters exactly -1e30."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.quant.quantizers import quantize_block
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    pool = torch.randn(2, 40, 3, 2, 32, 128, generator=g, device=dev).to(dtype)
    idx = torch.randint(-2, 40, (2, 3, 9), generator=g, device=dev, dtype=torch.int32)
    want = ref.recall_values_ref(pool, idx)
    for src in (pool, pool.cpu().pin_memory()):
        got = ops.recall_values(src, idx)
        assert got.dtype == dtype and torch.equal(got, want)
    for bits, group, d in ((8, 0, 128), (4, 0, 128), (8, 16, 64), (4, 32, 64)):
        pool_f = torch.randn(2, 12, 3, 2, 8, d, generator=g, device=dev)
        pool_f[:, 1] = 0
        pq, sc = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, 12, (2, 3, 5), generator=g, device=dev, dtype=torch.int32)
        want = ref.recall_values_quant_ref(pq, sc, idx, bits, dtype)
        for src, ssrc in ((pq, sc), (pq.cpu().pin_memory(), sc.cpu().pin_memory())):
            got = ops.recall_values_quant(src, ssrc, idx, bits=bits, out_dtype=dtype)
            assert got.dtype == dtype and torch.equal(got, want)
    q = torch.randn(2, 3, 4, 128, generator=g, device=dev).to(dtype)
    cent = torch.sort(torch.randn(2, 16, 3, 2, 128, generator=g, device=dev), dim=3).values
    cent = cent.to(dtype)
    count = torch.randint(0, 3, (2, 16, 3), generator=g, device=dev, dtype=torch.int32)
    got = ops.centroid_scores(q, cent, count, scale=0.09)
    torch.testing.assert_close(got, ref.centroid_scores_ref(q, cent, count, 0.09),
                               **_tol(torch.float32))
    assert (got.permute(0, 1, 3, 2)[(count == 0).permute(0, 2, 1)] == -1e30).all()


def _lanes(kind, shape, n_pages, g, dev):
    """idx of ``shape`` with every lane -1 ("none"), one valid lane ("one"),
    every lane valid ("all"), or a mix of valid, -1, -2 and ids past
    n_pages, which the kernels clamp ("mixed")."""
    if kind == "mixed":
        return torch.randint(-2, n_pages + 3, shape, generator=g, device=dev, dtype=torch.int32)
    idx = torch.full(shape, -1, dtype=torch.int32, device=dev)
    if kind == "all":
        idx = torch.randint(0, n_pages, shape, generator=g, device=dev, dtype=torch.int32)
    elif kind == "one":
        idx.view(-1)[idx.numel() // 2] = n_pages - 1
    return idx


GATHER_CASES = [   # B, n_pages, kv, p, d, n_sel, lanes
    (1, 5, 1, 16, 64, 1, "all"), (2, 9, 3, 16, 64, 57, "none"), (1, 40, 2, 64, 256, 57, "one"),
    (3, 7, 2, 64, 64, 1, "mixed"), (1, 300, 1, 16, 256, 9, "mixed"),
    (4, 259, 8, 32, 128, 56, "mixed"),
    (4, 40, 8, 16, 64, 300, "mixed"),   # 9600 items: each host-grid warp walks 32+ of them
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,n_pages,kv,p,d,n_sel,lanes", GATHER_CASES)
def test_cuda_gathers_bit_exact(B, n_pages, kv, p, d, n_sel, lanes, dtype):
    """recall_gather and recall_values from a device pool and from a pinned
    host pool equal their plain versions bit for bit: every lane -1, one
    valid lane, n_sel 1 and 57, B = 1, p 16 to 64, d 64 to 256, ids past
    n_pages clamped, the main shape, and more items than the host grid's
    warps can take 32 at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    pool = torch.randn(B, n_pages, kv, 2, p, d, generator=g, device=dev).to(dtype)
    idx = _lanes(lanes, (B, kv, n_sel), n_pages, g, dev)
    want_k, want_v = ref.recall_gather_ref(pool, idx)
    for src in (pool, pool.cpu().pin_memory()):
        k, v = ops.recall_gather(src, idx)
        assert k.dtype == dtype and torch.equal(k, want_k) and torch.equal(v, want_v)
        assert torch.equal(ops.recall_values(src, idx), want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (8, 16), (4, 16), (8, 32), (4, 32)])
@pytest.mark.parametrize("B,n_pages,kv,p,d,n_sel,lanes", [GATHER_CASES[i] for i in (0, 1, 2, 3, 6)])
def test_cuda_quant_gathers_bit_exact(B, n_pages, kv, p, d, n_sel, lanes, bits, group, dtype):
    """recall_gather_quant and recall_values_quant (int8 and int4, groups
    0, 16 and 32, zero pages at scale 1) from a device pool and from a
    pinned host pool equal their plain versions bit for bit, on the lane
    patterns and shapes of ``test_cuda_gathers_bit_exact``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.quant.quantizers import quantize_block
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    pool_f = torch.randn(B, n_pages, kv, 2, p, d, generator=g, device=dev)
    pool_f[:, 0] = 0
    pool, sc = quantize_block(pool_f, bits, group)
    idx = _lanes(lanes, (B, kv, n_sel), n_pages, g, dev)
    want_k, want_v = ref.recall_gather_quant_ref(pool, sc, idx, bits, dtype)
    for src, ssrc in ((pool, sc), (pool.cpu().pin_memory(), sc.cpu().pin_memory())):
        k, v = ops.recall_gather_quant(src, ssrc, idx, bits=bits, out_dtype=dtype)
        assert k.dtype == dtype and torch.equal(k, want_k) and torch.equal(v, want_v)
        got = ops.recall_values_quant(src, ssrc, idx, bits=bits, out_dtype=dtype)
        assert torch.equal(got, want_v)


@pytest.mark.cuda
def test_cuda_gather_grid_fits_the_sm_cap():
    """From a pinned pool each gather source launches a grid that
    HOST_GATHER_SMS SMs hold at once, by the occupancy the runtime reports
    for its kernels; from a device pool, one the whole card holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for source in ("recall_gather", "recall_gather_quant"):
        bps = ops.gather_blocks_per_sm(source, dev.index)
        assert bps >= 1
        assert ops.gather_grid(4 * 8 * 56, sms, bps, True) <= ops.HOST_GATHER_SMS * bps
        assert ops.gather_grid(4 * 8 * 56, sms, bps, False) <= sms * bps



# ---------------------------------------------------------------------------
# the fused selection kernels (select_pages, centroid_candidates)
# ---------------------------------------------------------------------------
SELECT_MODES = ["mean_softmax", "max_softmax", "mean_qk", "max_qk"]
SEL_P, SEL_SINK, SEL_WIN = 32, 128, 160


def select_inputs(kind, B, kv, G, d, N, n_sel, dtype, g, dev):
    from repro_torch.launch.select_bench import select_inputs
    return select_inputs(kind, B, kv, G, d, N, n_sel, dtype, g, dev, SEL_P, SEL_SINK, SEL_WIN)


def _select(fn, q, summ, length, n_sel, mode, cand=None):
    return fn(q, summ, length, n_sel, 0.09, SEL_P, SEL_SINK, SEL_WIN, mode, cand)


def _ops_select(q, summ, length, n_sel, scale, p, sink, win, mode, cand):
    return ops.select_pages(q, summ, length, n_sel=n_sel, scale=scale, page_size=p,
                            n_sink=sink, n_window=win, mode=mode, cand=cand, with_pooled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", SELECT_MODES)
@pytest.mark.parametrize("B,kv,N", [(4, 8, 259), (1, 8, 16384), (1, 2, 32768)])
def test_cuda_select_pages_matches_plain(B, kv, N, mode, dtype):
    """select_pages on the card against its plain version: page ids exactly
    equal on far-apart and forced-tie inputs (ties across the cluster's
    blocks, ties at probability 0.0), pooled within 2e-5, and tie-aware on
    random inputs; N 259 (the main path), 16384 (a block's pages just fit
    shared memory) and 32768 (1M tokens: the workspace in device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    G, d, n_sel = 4, 128, 56
    for kind in ("distinct", "tie", "underflow", "random"):
        q, summ, length = select_inputs(kind, B, kv, G, d, N, n_sel, dtype, g, dev)
        idx, pooled = _select(_ops_select, q, summ, length, n_sel, mode)
        want_idx, want_pooled = _select(ref.select_pages_ref, q, summ, length, n_sel, mode)
        assert idx.dtype == torch.int32 and idx.shape == (B, kv, n_sel)
        torch.testing.assert_close(pooled, want_pooled, atol=2e-5, rtol=2e-5)
        if kind == "random":
            from repro_torch.launch.select_bench import tie_aware_mismatch
            assert tie_aware_mismatch(idx, want_idx, want_pooled) is None
        else:
            assert torch.equal(idx, want_idx), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", SELECT_MODES)
@pytest.mark.parametrize("N", [259, 4096])
def test_cuda_select_pages_batch_invariant(N, mode, dtype):
    """A row's ids and pooled scores are bit for bit the same whatever the
    launch holds: all 32 (request, KV head) rows, each tensor-parallel
    shard's 16 (the KV heads split in two), or one row alone, though the
    cluster's split follows the row count (ops.select_split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(12)
    B, kv, G, d, n_sel = 4, 8, 4, 128, 56
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {ops.select_split(N, rows, sms) for rows in (B * kv, B * kv // 2, 1)}
    for kind in ("random", "tie"):
        q, summ, length = select_inputs(kind, B, kv, G, d, N, n_sel, dtype, g, dev)
        idx, pooled = _select(_ops_select, q, summ, length, n_sel, mode)
        halves = [_select(_ops_select, q[:, h:h + kv // 2].contiguous(),
                          summ[:, :, h:h + kv // 2].contiguous(), length, n_sel, mode)
                  for h in (0, kv // 2)]
        assert torch.equal(idx, torch.cat([h[0] for h in halves], dim=1)), kind
        assert torch.equal(pooled, torch.cat([h[1] for h in halves], dim=1)), kind
        one_idx, one_pooled = _select(_ops_select, q[1:2, 3:4].contiguous(),
                                      summ[1:2, :, 3:4].contiguous(), length[1:2], n_sel, mode)
        assert torch.equal(idx[1:2, 3:4], one_idx) and torch.equal(pooled[1:2, 3:4], one_pooled)
    assert len(splits) > 1, splits          # 4 blocks a row at 32 rows, 8 at 16 and at 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", SELECT_MODES)
def test_cuda_select_pages_candidates_match_plain(mode, dtype):
    """select_pages with candidate ids (-1 among them, read in place) on the
    card: ids exactly equal to the plain version's on far-apart inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(9)
    B, kv, G, d, N, n_sel, m = 4, 8, 4, 128, 259, 56, 224
    q, summ, length = select_inputs("distinct", B, kv, G, d, N, n_sel, dtype, g, dev)
    cand = torch.stack([torch.randperm(N, generator=g, device=dev)[:m] for _ in range(B * kv)])
    cand = cand.reshape(B, kv, m).to(torch.int32)
    cand[:, :, -30:] = -1
    cand[0, 0] = -1                                         # a row of -1 candidates only
    idx, pooled = _select(_ops_select, q, summ, length, n_sel, mode, cand)
    want_idx, want_pooled = _select(ref.select_pages_ref, q, summ, length, n_sel, mode, cand)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(pooled, want_pooled, atol=2e-5, rtol=2e-5)
    assert (idx[0, 0] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("N", [259, 16384])
def test_cuda_centroid_candidates_match_plain(N, dtype):
    """centroid_candidates on the card: candidate ids exactly equal to the
    plain version's (pages of a cluster tie by construction and come in
    page-id order), with empty clusters and unassigned pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    B, kv, G, d, C = 4, 8, 4, 128, 16
    q = torch.randn(B, kv, G, d, generator=g, device=dev).to(dtype)
    cent = torch.sort(torch.randn(B, C, kv, 2, d, generator=g, device=dev), dim=3).values
    cent = cent.to(dtype)
    assign = torch.randint(-1, C, (B, N, kv), generator=g, device=dev, dtype=torch.int32)
    count = torch.randint(1, 5, (B, C, kv), generator=g, device=dev, dtype=torch.int32)
    count[:, 3] = 0
    length = torch.full((B,), (N - 2) * SEL_P + 7, dtype=torch.int32, device=dev)
    length[1] = SEL_SINK + SEL_WIN + 40 * SEL_P                # fewer selectable pages than m
    for m in (224, min(N, 4000)):
        got = ops.centroid_candidates(q, cent, count, assign, length, m=m, scale=0.09,
                                      page_size=SEL_P, n_sink=SEL_SINK, n_window=SEL_WIN)
        want = ref.centroid_candidates_ref(q, cent, count, assign, length, m, 0.09, SEL_P,
                                           SEL_SINK, SEL_WIN)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert (got[1] == -1).any()


# ---------------------------------------------------------------------------
# continuous scheduler on the card
# ---------------------------------------------------------------------------
SMOKE_FKV = dict(page_size=8, budget=64, n_sink=8, n_window=8, offload="host")


def _smoke_requests(cfg, eos_uid=None, eos=None):
    import numpy as np

    from repro_torch.serving.engine import Request
    lens, news = (72, 101, 56, 101, 80), (9, 4, 12, 5, 7)
    return [Request(uid=i, tokens=np.random.default_rng(i).integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m,
                    eos_token=eos if i == eos_uid else None)
            for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.cuda
@pytest.mark.parametrize("method,kv_quant", [("freekv", "none"), ("freekv", "int8"),
                                             ("shadowkv", "none"), ("centroid", "none")])
def test_cuda_continuous_tokens_equal_cpu(method, kv_quant):
    """The continuous scheduler on the card (kernels, pinned pool, staged
    recall on the side stream) gives the CPU's greedy tokens and step
    counts: granite-3-8b-smoke at float32, five requests of mixed lengths
    over two slots, one of them ended by an eos inside a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(method=method, kv_quant=kv_quant, **SMOKE_FKV)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    cpu_params = {"embed": {k: t.cpu() for k, t in params["embed"].items()},
                  "final_norm": {k: t.cpu() for k, t in params["final_norm"].items()},
                  "layers": [{n: {k: t.cpu() for k, t in sub.items()} for n, sub in lp.items()}
                             for lp in params["layers"]]}
    runs = {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        eng = ServeEngine(cfg, fkv, p, max_len=128, batch_size=2, device=dev if where == "cuda"
                          else "cpu")
        full = eng.generate(_smoke_requests(cfg))
        toks2 = full[2].tokens          # an eos first made at the third token or later
        eos = next(t for i, t in enumerate(toks2) if i >= 2 and t not in toks2[:i])
        outs = eng.generate(_smoke_requests(cfg, eos_uid=2, eos=eos))
        runs[where] = ([o.tokens for o in full], [o.tokens for o in outs],
                       eng.last_metrics.steps, eng.last_logits_finite)
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][3] is True


@pytest.mark.cuda
def test_cuda_slot_pool_round_trip_with_staged_recall_in_flight():
    """SlotPool on the card with a pinned pool: a slot read out while its
    staged recall is in flight on the side stream, written into another
    slot and read back, is bit for bit the same; a state prefilled straight
    into a slot equals one prefilled alone and inserted, page for page up
    to its length; a freed slot resets to the empty state but for its
    pool pages, which keep their bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv_slots import POOL_KEYS
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    # tau -1: no head is corrected, so every step stages its recall
    fkv = FreeKVConfig(method="freekv", tau=-1.0, **SMOKE_FKV)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    eng = ServeEngine(cfg, fkv, params, max_len=128, batch_size=3, device=dev)
    pool = eng.make_slot_pool(3)
    assert pool.state["layers"][0]["pool"].is_pinned()
    empty = pool.extract(1)
    req = _smoke_requests(cfg)[0]
    logits, st, _, _ = eng.prefill_one(req, pool, 0)
    pool.insert(st, 0)
    alone_logits, alone, _, _ = eng.prefill_one(req)
    assert torch.equal(logits, alone_logits)
    got = pool.extract(0)
    n_full = len(req.tokens) // fkv.page_size
    for i, layer in enumerate(alone["layers"]):
        for k, t in layer.items():
            want = t[:, :n_full] if k in ("pool", "pool_scale") else t
            have = got["layers"][i][k][:, :n_full] if k in ("pool", "pool_scale") \
                else got["layers"][i][k]
            assert torch.equal(have.cpu(), want.cpu()), k
    cur = torch.argmax(logits, dim=-1).expand(3)[:, None].contiguous()
    for _ in range(4):
        logits, pool.state, _ = eng.step(pool.state, cur)
        cur = torch.argmax(logits, dim=-1)[:, None]
    assert "sel_ready" in pool.state["layers"][0]          # a staged recall in flight
    a = pool.extract(0)
    pool.insert(a, 2)
    b = pool.extract(2)
    for key in ("pos", "pos_host"):
        assert torch.equal(a[key], b[key])
    for la, lb in zip(a["layers"], b["layers"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    slot = pool.alloc(7)
    before = pool.extract(slot)
    pool.free(slot)
    pool.flush_resets()
    reset = pool.extract(slot)
    for le, lb, lr in zip(empty["layers"], before["layers"], reset["layers"]):
        for k in le:       # the pool pages keep their bytes (kv_slots.POOL_KEYS)
            assert torch.equal(lb[k] if k in POOL_KEYS else le[k], lr[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("method,kv_quant", [("freekv", "none"), ("freekv", "int8"),
                                             ("shadowkv", "none"), ("centroid", "none")])
def test_cuda_decode_window_makes_no_host_sync(method, kv_quant):
    """A decode window on the card never makes the host wait for it: under
    torch.cuda.set_sync_debug_mode("error") a read back (.cpu(), .item(),
    .tolist()), a copy from pageable host memory and a data-dependent
    shape (nonzero, boolean indexing) each raise. Ragged rows (two requests
    of different lengths and an idle slot at length 0), pages completing in
    every row during the window, the staged recall in flight. The window's
    one read comes after, as the scheduler makes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.metrics import EngineMetrics
    from repro_torch.serving.scheduler import _Lanes
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(method=method, kv_quant=kv_quant, **SMOKE_FKV)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    eng = ServeEngine(cfg, fkv, params, max_len=128, batch_size=3, device=dev)
    pool = eng.make_slot_pool(3)
    lanes = _Lanes(3, dev)
    for req in _smoke_requests(cfg)[:2]:              # 72 and 101 tokens
        slot = pool.alloc(req.uid)
        logits, st, _, _ = eng.prefill_one(req, pool, slot)
        pool.insert(st, slot)
        lanes.admit(slot, int(torch.argmax(logits[0])), np.zeros(2, np.int64), 1, 100, None)
    loop = lanes.device_loop(EngineMetrics())
    state, loop, *_ = eng.decode_window(pool.state, loop, 2)     # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loop, toks, valid, stats, finite = eng.decode_window(state, loop, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert valid[:, :2].all() and not valid[:, 2].any()
    assert finite.all()
    assert state["pos_host"].tolist() == state["pos"].tolist() == [72 + 18, 101 + 18, 18]



@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b-smoke", "jamba-1.5-large-398b-smoke"])
def test_cuda_moe_and_mamba_window_makes_no_host_sync(arch):
    """A decode window through MoE FFNs (deepseek) and a Mamba mixer with a
    MoE FFN (jamba) makes no host wait under
    torch.cuda.set_sync_debug_mode("error"): the capacity comes from shapes
    and the dispatch and combine read nothing back. Two requests and an
    idle slot stepping from the empty state; the window's tokens equal the
    CPU's (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.metrics import EngineMetrics
    from repro_torch.serving.scheduler import _Lanes
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    fkv = FreeKVConfig(**SMOKE_FKV)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    toks = {}
    for where in ("cuda", "cpu"):
        p = params if where == "cuda" else {k: _to_cpu(v) for k, v in params.items()}
        eng = ServeEngine(cfg, fkv, p, max_len=128, batch_size=3,
                          device=dev if where == "cuda" else "cpu")
        pool = eng.make_slot_pool(3)
        lanes = _Lanes(3, eng.device)
        for req in _smoke_requests(cfg)[:2]:
            slot = pool.alloc(req.uid)
            logits, st, _, _ = eng.prefill_one(req, pool, slot)
            pool.insert(st, slot)
            lanes.admit(slot, int(torch.argmax(logits[0])), np.zeros(2, np.int64), 1, 100, None)
        loop = lanes.device_loop(EngineMetrics())
        state, loop, *_ = eng.decode_window(pool.state, loop, 2)
        if where == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, loop, t, valid, stats, finite = eng.decode_window(state, loop, 12)
        finally:
            if where == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        assert finite.all() and valid[:, :2].all() and not valid[:, 2].any()
        toks[where] = t[:, :2].cpu().tolist()
    assert toks["cuda"] == toks["cpu"]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_spec_window_makes_no_host_sync(temperature):
    """A speculative window (draft_len 3, verify rows, rollback recall,
    drafter update, its stop flags polled through events) never makes the
    host wait for the card: under torch.cuda.set_sync_debug_mode("error"),
    greedy and sampled; its emitted rows are what draft_len 0 emits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.metrics import EngineMetrics
    from repro_torch.serving.sampling import SamplerConfig, request_key
    from repro_torch.serving.scheduler import _Lanes
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    out = {}
    for dl in (3, 0):
        fkv = FreeKVConfig(method="freekv", draft_len=dl, **SMOKE_FKV)
        eng = ServeEngine(cfg, fkv, params, max_len=128, batch_size=3, device=dev,
                          sampler=SamplerConfig(temperature))
        pool = eng.make_slot_pool(3)
        lanes = _Lanes(3, dev)
        for req in _smoke_requests(cfg)[:2]:
            slot = pool.alloc(req.uid)
            logits, st, _, _ = eng.prefill_one(req, pool, slot)
            pool.insert(st, slot)
            rk = request_key(0, req.uid)
            lanes.admit(slot, int(eng.sample_slot(logits, rk, 0)[0]), rk.numpy(), 1, 12, None)
        loop = lanes.device_loop(EngineMetrics())
        torch.cuda.synchronize()
        if dl:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, loop, toks, valid, stats, finite = eng.decode_window(pool.state, loop, 11)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert finite.all()
        toks, valid = toks.cpu(), valid.cpu()
        if dl:          # committed rows in order: (n, S, B) -> per lane
            out[dl] = [toks[:, :, b][valid[:, :, b]].tolist() for b in range(3)]
        else:
            out[dl] = [toks[:, b][valid[:, b]].tolist() for b in range(3)]
    assert out[3] == out[0] and len(out[0][0]) == 11 and not out[0][2]

# ---------------------------------------------------------------------------
# the page-fill kernels (fill_pages, complete_page)
# ---------------------------------------------------------------------------
FILL_QUANT = [("none", 0), ("int8", 0), ("int8", 16), ("int4", 0), ("int4", 32)]


def _paging_state(kv_quant, group, B, max_len, dtype, dev, offload):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.core import paging
    cfg = get_config("llama31-8b")
    fkv = FreeKVConfig(page_size=32, kv_quant=kv_quant, quant_group_size=group, offload=offload)
    return cfg, paging.init_kv_state(cfg, fkv, B, max_len, dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,group", FILL_QUANT)
@pytest.mark.parametrize("k_dtype,dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.bfloat16)], ids=str)
def test_cuda_fill_pages_matches_plain(k_dtype, dtype, kv_quant, group):
    """fill_pages equal to its plain version bit for bit: summaries, payload
    and scales, K and V prefix views of a longer prompt, outputs the first
    pages of longer tensors; and ``prefill_fill_pool`` into a device pool
    and into a pinned pool (a staging block and a copy a row) equal to the
    same on the CPU, every leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.core import paging
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(20)
    cfg, st = _paging_state(kv_quant, group, 2, 1100, dtype, dev, "sim")
    kv, d = cfg.n_kv_heads, cfg.d_head
    k = torch.randn(2, 1040, kv, d, generator=g, device=dev).to(k_dtype)[:, :1000]
    v = torch.randn(2, 1040, kv, d, generator=g, device=dev).to(k_dtype)[:, :1000]
    k[0, 64:96] = 0                                       # a zero page: scale 1
    v[0, 64:96] = 0
    n = 1000 // 32
    outs = {}
    for name, fn in (("kernel", ops.fill_pages), ("plain", ref.fill_pages_ref)):
        s = {key: t.clone() for key, t in st.items() if key in ("summ", "pool", "pool_scale")}
        fn(k, v, s["summ"][:, :n], s["pool"][:, :n],
           s["pool_scale"][:, :n] if "pool_scale" in s else None)
        outs[name] = s
    torch.cuda.synchronize()
    for key in outs["plain"]:
        assert torch.equal(outs["kernel"][key], outs["plain"][key]), key
    states = {}
    for where, offload in (("device", "sim"), ("pinned", "host"), ("cpu", "host")):
        place = dev if where != "cpu" else torch.device("cpu")
        _, s = _paging_state(kv_quant, group, 2, 1100, dtype, place, offload)
        states[where] = paging.prefill_fill_pool(s, k.to(place), v.to(place), 1000)
    torch.cuda.synchronize()
    assert states["pinned"]["pool"].is_pinned()
    for key, want in states["cpu"].items():
        for where in ("device", "pinned"):
            assert torch.equal(states[where][key].cpu(), want), (where, key)


@pytest.mark.cuda
@pytest.mark.parametrize("offload", ["sim", "host"])
@pytest.mark.parametrize("kv_quant,group", FILL_QUANT)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_complete_page_matches_plain(dtype, kv_quant, group, offload):
    """complete_page equal to its plain version bit for bit, to a device and
    to a pinned pool, on 4 rows whose post-append lengths complete no page,
    some pages and a page in every row, over a 150-slot ring (a page wraps
    its end); a row that completes nothing keeps every byte of its pool,
    scales and summaries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    cfg, st = _paging_state(kv_quant, group, 4, 1100, dtype, dev, offload)
    kv, d = cfg.n_kv_heads, cfg.d_head
    win_k = torch.randn(4, 150, kv, d, generator=g, device=dev).to(dtype)
    win_v = torch.randn(4, 150, kv, d, generator=g, device=dev).to(dtype)
    keys = [key for key in ("summ", "pool", "pool_scale") if key in st]
    for key in keys:                                   # old bytes, to be kept or replaced
        st[key].copy_(torch.randint(-50, 50, st[key].shape, generator=g, device=dev))
    # page 4 of a 150-slot ring: slots 128..149, 0..9
    for lengths in ([33, 70, 101, 5], [160, 64, 99, 1024], [160, 32, 96, 1024]):
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        done = [n % 32 == 0 for n in lengths]
        want = {key: st[key].to(dev).clone() for key in keys}
        ref.complete_page_ref(win_k, win_v, length, *(want.get(key) for key in keys))
        before = {key: st[key].clone() for key in keys}
        ops.complete_page(win_k, win_v, length, *(st[key] for key in keys))
        torch.cuda.synchronize()
        for key in keys:
            assert torch.equal(st[key].to(dev), want[key]), (lengths, key)
            for b in range(4):
                if not done[b]:
                    assert torch.equal(st[key][b], before[key][b]), (lengths, key, b)
    assert ops.complete_page.launches >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_cuda_append_token_makes_no_host_sync(kv_quant):
    """A decode append in which one row completes a page, into a pinned pool:
    under torch.cuda.set_sync_debug_mode("error") nothing makes the host
    wait for the card (no read of the lengths, no pageable copy), and the
    state equals the same appends on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.core import paging
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(22)
    states = {}
    _, st = _paging_state(kv_quant, 0, 3, 400, torch.bfloat16, dev, "host")
    k = torch.randn(3, 256, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(3, 256, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([256, 250, 286], dtype=torch.int32)
    new = [torch.randn(2, 3, 8, 128, generator=g, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    for where in ("cuda", "cpu"):
        place = dev if where == "cuda" else torch.device("cpu")
        _, s = _paging_state(kv_quant, 0, 3, 400, torch.bfloat16, place, "host")
        s = paging.prefill_fill_pool(s, k.to(place), v.to(place), lengths.to(place))
        if where == "cuda":
            paging.append_token(s, new[0][0], new[0][1])        # loads the kernel
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                paging.append_token(s, new[1][0], new[1][1])    # row 2 completes page 8
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        else:
            for kn, vn in new:
                paging.append_token(s, kn.cpu(), vn.cpu())
        states[where] = s
    assert states["cpu"]["length"].tolist() == [258, 252, 288]
    assert states["cpu"]["pool"][2, 8].abs().sum() > 0
    for key, want in states["cpu"].items():
        assert torch.equal(states["cuda"][key].cpu(), want), key


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_cuda_slot_swap_roundtrip_exact(kv_quant):
    """On the card with the pool in pinned host memory: a slot swapped out
    after decode steps (a staged recall in flight) and swapped into another
    slot reads back bit for bit, every leaf at its stored dtype, the
    packed pool and its scales included; the swap's host tensors are
    pinned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(method="freekv", tau=-1.0, kv_quant=kv_quant,
                       quant_group_size=16 if kv_quant == "int4" else 0, **SMOKE_FKV)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    eng = ServeEngine(cfg, fkv, params, max_len=128, batch_size=3, device=dev)
    pool = eng.make_slot_pool(3)
    logits, st, _, _ = eng.prefill_one(_smoke_requests(cfg)[0], pool, 0)
    pool.insert(st, 0)
    cur = torch.argmax(logits, dim=-1).expand(3)[:, None].contiguous()
    for _ in range(3):
        logits, pool.state, _ = eng.step(pool.state, cur)
        cur = torch.argmax(logits, dim=-1)[:, None]
    assert "sel_ready" in pool.state["layers"][0]          # a staged recall in flight
    host = pool.swap_out(0)
    before = pool.extract(0)
    assert all(t.is_pinned() for layer in host["layers"] for t in layer.values())
    pool.swap_in(host, 2)
    after = pool.extract(2)
    for key in ("pos", "pos_host"):
        assert torch.equal(before[key], after[key])
    for lb, la, lh in zip(before["layers"], after["layers"], host["layers"]):
        for k in lb:
            assert lh[k].dtype == lb[k].dtype and torch.equal(lb[k], la[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(4, 7, 128), (5, 3, 64), (32, 1, 80), (4, 2, 256)],
                         ids=lambda x: "kv%d-G%d-d%d" % x)
def test_cuda_select_pages_per_head_and_kept_ids(layout):
    """On the card: select_pages per query head (Quest) and pooled with the
    unselectable lanes' ids kept (RaaS's seeding), at the served archs'
    head layouts, ids exactly the plain version's on far-apart inputs and
    where fewer pages are selectable than lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    from repro_torch.launch.select_bench import select_inputs
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    kv, G, d = layout
    q, summ, length = select_inputs("distinct", 2, kv, G, d, 259, 56, torch.bfloat16, g, dev)
    for n in (length, torch.full_like(length, 128 + 160 + 5 * 32)):
        for per_head in (True, False):
            kw = dict(n_sel=56, scale=d ** -0.5, page_size=32, n_sink=128, n_window=160,
                      per_head=per_head, keep_invalid=True)
            got = ops.select_pages(q, summ, n, **kw)
            want, _ = ref.select_pages_ref(q, summ, n, 56, d ** -0.5, 32, 128, 160,
                                           "mean_softmax", None, per_head, True)
            assert torch.equal(got, want) and bool((got >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("tq", [300, 97])
def test_cuda_flash_prefill_d80(dtype, tq):
    """On the card: flash_prefill at d_head 80 (stablelm-3b) on the d=128
    tiles, a whole prompt and an extension, within ``_tol`` of its plain
    version; the output's layout is q's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(1, tq, 4, 80, generator=g, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn(1, 300, 4, 80, generator=g, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(1, 300, 4, 80, generator=g, device=dev).to(dtype).transpose(1, 2)
    got = ops.flash_prefill(q, k, v, scale=80 ** -0.5)
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.flash_prefill_ref(q, k, v, 80 ** -0.5).float(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_sampler_streams_equal_cpu(dtype):
    """On the card: the per-request keys, the random bits and the uniform
    draws equal the CPU's bit for bit (the streams ``test_torch_sampling``
    holds equal to JAX's); greedy and sampled ids equal the CPU's at a
    llama-sized vocabulary but where the CPU's top two perturbed logits
    tie within 4 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.serving import sampling
    dev = torch.device("cuda", 0)
    keys = torch.stack([sampling.request_key(1234, u) for u in range(8)])
    counts = torch.arange(8, dtype=torch.int32) * 5
    sk = sampling.step_keys(keys, counts)
    sk_dev = sampling.step_keys(keys.to(dev), counts.to(dev))
    assert torch.equal(sk, sk_dev.cpu())
    for width in (8, 16, 32):
        assert torch.equal(sampling.random_bits(sk, width, (4096,)),
                           sampling.random_bits(sk_dev, width, (4096,)).cpu())
    tiny = torch.finfo(dtype).tiny
    assert torch.equal(sampling.uniform(sk[0], (8, 4096), dtype, tiny, 1.0),
                       sampling.uniform(sk_dev[0], (8, 4096), dtype, tiny, 1.0).cpu())
    g = torch.Generator().manual_seed(0)
    logits = (torch.randn((8, 128512), generator=g) * 3).to(dtype)
    for top_p in (1.0, 0.9):
        cfg = sampling.SamplerConfig(0.8, top_p)
        a = sampling.sample_step(logits, cfg, sk)
        b = sampling.sample_step(logits.to(dev), cfg, sk_dev).cpu()
        pert = sampling.gumbel(sk, (128512,), dtype).float() + \
            sampling._filter_logits(logits, cfg).float()
        top2 = torch.topk(pert, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 4 * torch.finfo(dtype).eps * top2[:, 0].abs()
        assert bool(((a == b) | tie).all()), (top_p, a, b)
    assert torch.equal(sampling.sample_step(logits, sampling.SamplerConfig(), None),
                       sampling.sample_step(logits.to(dev), sampling.SamplerConfig(), None).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["freekv", "infinigen"])
def test_cuda_verify_rows_equal_single_steps(method):
    """On the card, bf16, pinned pool, the overlap's side stream: each row
    of a verify pass is bit for bit a single ``serve_step`` from the same
    state (two identical prefills), logits and stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models import model
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(method=method, draft_len=3, **SMOKE_FKV)
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 96), generator=g).to(dev)
    block = torch.randint(0, cfg.vocab_size, (3, 4), generator=g).to(dev)

    def state():
        return model.prefill(cfg, fkv, params, {"tokens": toks}, 160,
                             state_dtype=torch.bfloat16)[1]
    st = state()
    single = []
    for j in range(4):
        lg, st, s = model.serve_step(cfg, fkv, params, st, block[:, j:j + 1],
                                     collect_stats=True)
        single.append((lg, s))
    logits, _, rows, _ = model.serve_step_verify(cfg, fkv, params, state(), block)
    for j, (lg, s) in enumerate(single):
        assert torch.equal(logits[:, j], lg), j
        assert all(torch.equal(rows[k][j], s[k]) for k in rows), j


@pytest.mark.cuda
def test_cuda_service_path_equals_cpu_and_spans_carry_device_time():
    """The live-serving path on the card (granite-3-8b-smoke, fp32, pinned
    pool, recall overlap): three requests submitted through an
    ``EngineService`` while the engine runs on its worker thread, one
    cancelled after its second token, give the CPU engine's direct greedy
    tokens (the cancelled one a prefix of them), and every slot is free at
    the end. Then, under ``torch.profiler``, each ``annotate`` span of two
    decode steps has a device-side row with time: its extent on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models import model
    from repro_torch.obs import Observability
    from repro_torch.obs.trace import ANNOTATED_SPANS
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.frontend import EngineService
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(method="freekv", **SMOKE_FKV)
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    g = np.random.default_rng(3)
    spec = [(0, 160, 12), (1, 96, 20), (2, 200, 8)]          # (uid, prompt, new tokens)
    prompts = {u: g.integers(0, cfg.vocab_size, n).astype(np.int32) for u, n, _ in spec}

    def engine(p, device, obs=None):
        return ServeEngine(cfg, fkv, p, max_len=256, batch_size=2, device=device, obs=obs)

    want = {c.uid: c.tokens for c in engine(cpu_params, "cpu").generate(
        [Request(uid=u, tokens=prompts[u], max_new_tokens=m) for u, _, m in spec])}
    eng = engine(params, dev, Observability.full())
    svc = EngineService(eng).start()
    got, ends = {u: [] for u, _, _ in spec}, {}
    done = {u: threading.Event() for u, _, _ in spec}

    def on_event(kind, payload):
        u = payload["uid"]
        if kind == "token":
            got[u].append(payload["token"])
            if u == 1 and payload["index"] == 1:
                svc.cancel(1)
            return
        ends[u] = (kind, payload)
        done[u].set()

    for u, _, m in spec:
        svc.submit(prompts[u], m, on_event, uid=u)
    assert all(ev.wait(300) for ev in done.values())
    svc.stop()
    assert all(kind == "finish" for kind, _ in ends.values()), ends
    assert ends[1][1]["cancelled"] and got[1] == want[1][:len(got[1])]
    for u in (0, 2):
        assert not ends[u][1]["cancelled"] and got[u] == want[u], u
    assert eng.last_metrics.cancellations == 1 and eng._pool.owner == [None, None]

    toks = torch.from_numpy(np.stack([prompts[0][:96], prompts[1]])).long().to(dev)
    logits, state = model.prefill(cfg, fkv, params, {"tokens": toks}, 160)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            logits, state = model.serve_step(cfg, fkv, params, state,
                                             torch.argmax(logits, dim=-1)[:, None])
        torch.cuda.synchronize()
    # each span's device-side row: its extent on the card, which covers the
    # kernels launched inside it, the port's own (through ctypes) included
    rows = {e.key: e for e in prof.key_averages()
            if e.key in ANNOTATED_SPANS and e.device_type == torch.autograd.DeviceType.CUDA}
    assert set(rows) == set(ANNOTATED_SPANS)
    for name, e in rows.items():
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        assert dev_us > 0, f"{name} carries no device time"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,T", [(1, 1500), (1, 1536), (4, 1500)])
def test_cuda_flash_prefill_bidirectional(dtype, B, T):
    """On the card: flash_prefill with ``causal=False`` at whisper's encoder
    shape (6/6 heads, d_head 64, T = 1500 frames, which no tile divides; and
    1536, which the tiles do) within ``_tol`` of its plain version, from the
    model's transposed (B, T, H, d) views."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, T, 6, 64, generator=g, device=dev).to(dtype).transpose(1, 2)
               for _ in range(3))
    got = ops.flash_prefill(q, k, v, scale=0.125, causal=False)
    torch.testing.assert_close(got.float(), ref.flash_prefill_ref(q, k, v, 0.125, False).float(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cuda_xlstm_decode_makes_no_host_sync(kind):
    """On the card: an xLSTM decode step at xlstm-350m's width (B = 4) runs
    under ``set_sync_debug_mode("error")``, its state stays float32, and
    its output and state equal the CPU's within 1e-4 (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    cfg = get_config("xlstm-350m")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(6)

    def normal(shape, std):
        return torch.randn(shape, generator=g).mul_(std)
    p = getattr(xlstm, kind + "_init")(cfg, normal)
    x = torch.randn(4, 1, cfg.d_model, generator=g)
    s_cpu = getattr(xlstm, kind + "_init_state")(cfg, 4, "cpu")
    y_cpu, s_cpu = getattr(xlstm, kind + "_decode_step")(cfg, p, x, s_cpu)
    p_dev = {key: t.to(dev) for key, t in p.items()}
    s = getattr(xlstm, kind + "_init_state")(cfg, 4, dev)
    xd = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, s = getattr(xlstm, kind + "_decode_step")(cfg, p_dev, xd, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    for key, t in s.items():
        assert t.dtype == torch.float32
        torch.testing.assert_close(t.cpu(), s_cpu[key], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m-smoke", "whisper-tiny-smoke",
                                  "internvl2-26b-smoke"])
def test_cuda_new_archs_tokens_equal_cpu(arch):
    """On the card: the continuous engine serves the xLSTM stack, the
    encoder-decoder (its encoder through flash_prefill(causal=False)) and
    the frontend prefix with the CPU's greedy tokens (float32, 3 requests
    over 2 slots, seeded frontends)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this on the card")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = get_config(arch)
    dev = torch.device("cuda", 0)
    fkv = FreeKVConfig(page_size=8, budget=64, n_sink=8, n_window=8)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m,
                    frontend=None if cfg.frontend is None else (0.1 * rng.standard_normal(
                        (cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32))
            for i, (n, m) in enumerate(((96, 9), (80, 5), (104, 7)))]
    toks = {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        eng = ServeEngine(cfg, fkv, p, max_len=192, batch_size=2, device=dev if where == "cuda"
                          else "cpu")
        toks[where] = [o.tokens for o in eng.generate(reqs)]
    assert toks["cuda"] == toks["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "deepseek-moe-16b-smoke"])
def test_cuda_train_step_equals_cpu(arch):
    """On the card: one training step (forward_train through the chunked
    attention's per-chunk checkpoints at T 2304, remat, AdamW) from the same
    float32 params and batch as the CPU's gives the CPU's loss within 1e-4
    relative and params within 1e-3 relative L2 a leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 6 runs this on the card")
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.training.optimizer import AdamWConfig, tree_leaves, tree_map
    from repro_torch.training.train_step import init_train, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dev = torch.device("cuda", 0)
    params, opt = init_train(cfg, opt_cfg, seed=0, device=dev)
    cpu = (tree_map(lambda t: t.cpu(), params), tree_map(lambda t: t.cpu(), opt))
    tokens = torch.from_numpy(next(lm_batches(cfg.vocab_size, 2304, 1, seed=0)))
    step = make_train_step(cfg, opt_cfg)
    params, _, m = step(params, opt, {"tokens": tokens.to(dev)})
    cpu_params, _, cm = step(*cpu, {"tokens": tokens})
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-4 * abs(float(cm["loss"]))
    want = dict(tree_leaves(cpu_params))
    for path, t in tree_leaves(params):
        w = want[path].double()
        assert float((t.cpu().double() - w).norm()) <= 1e-3 * float(w.norm()), path
