"""The port's CUDA kernels against their plain PyTorch versions on the card.

Skips without a card. On a machine with an H100 (this file imports no JAX,
so the repo's conftest can be left out there):

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
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

