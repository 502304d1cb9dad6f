"""The CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip with a reason.
Run them on a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as TA  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import grid_graph, star_graph  # noqa: E402
from repro_torch.kernels.build import LIBRARIES  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402
from repro_torch.kernels.cl.precision import \
    PRECISION_TOLERANCES as TK_PRECISION  # noqa: E402
from repro_torch.kernels.gram import kernel as gmod  # noqa: E402
from repro_torch.kernels.swa import kernel as smod  # noqa: E402
from repro_torch.kernels.swa.ops import swa_op  # noqa: E402
from repro_torch.models import decoding as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

pytestmark = pytest.mark.cuda
KINDS = {"ising": 1, "gaussian": 1, "potts": 2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [2, 5, 17, 65])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_newton_kernel_matches_plain(dev, kind, d, weighted):
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    C, k, n = KINDS[kind], 5, 1001
    xi = torch.randint(0, 3, (k, n), generator=gen, device=dev).float()
    if kind == "ising":
        xi = 2.0 * (xi > 0).float() - 1.0
    Zb = torch.randn((k, C, d, n), generator=gen, device=dev)
    base = 0.1 * torch.randn((k, C, n), generator=gen, device=dev)
    W = 0.1 * torch.randn((k, d * C), generator=gen, device=dev)
    sw = ((torch.rand((k, n), generator=gen, device=dev) < .7).float()
          if weighted else None)
    n0 = nmod.bucket_newton_stats.launches
    got = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
    want = nmod.bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
    assert nmod.bucket_newton_stats.launches == n0 + 1
    # float32 sums in another order
    assert all(_rel(g, w) <= 1e-4 for g, w in zip(got, want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("kind,C,d,k,n", [
    ("ising", 1, 65, 1, 4000),     # one node: the many-split wide path
    ("potts", 2, 65, 3, 1001),     # d*C = 130
    ("ising", 1, 8, 5, 4001),      # widest narrow bucket; n divides no tile
    ("ising", 1, 9, 5, 4001),      # narrowest wide bucket
    ("gaussian", 1, 84, 2, 1001),  # 252 tiles: one tile group
    ("gaussian", 1, 85, 2, 1001),  # 275 tiles: two tile groups
    ("potts", 3, 100, 1, 500),     # d*C = 300, the old width limit
])
def test_newton_kernel_regimes_match_plain_and_repeat(dev, kind, C, d, k, n,
                                                      dtype, weighted):
    gen = torch.Generator(device=dev)
    gen.manual_seed(d * C + n)
    xi = torch.randint(0, C + 1, (k, n), generator=gen, device=dev).float()
    if kind == "ising":
        xi = 2.0 * (xi > 0).float() - 1.0
    Zb = torch.randn((k, C, d, n), generator=gen, device=dev).to(dtype)
    base = (0.1 * torch.randn((k, C, n), generator=gen, device=dev)).to(dtype)
    W = 0.1 * torch.randn((k, d * C), generator=gen, device=dev) / d ** 0.5
    sw = ((torch.rand((k, n), generator=gen, device=dev) < .7).to(dtype)
          if weighted else None)
    xi = xi.to(dtype)
    got = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
    again = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
    want = nmod.bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
    # partials are summed in a fixed order: bitwise equal on a second call
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # float32 sums in another order (against float64 sums for a float64
    # design)
    assert all(g.dtype == torch.float32 for g in got)
    assert all(_rel(g, w) <= 1e-4 for g, w in zip(got, want))


@pytest.mark.parametrize("C,d", [(1, 8), (1, 9), (2, 4)])
def test_newton_library_refuses_the_other_regime(dev, C, d):
    # the wrapper plans the regime; the library launches only the regime it
    # picks itself, so the two copies of the rule cannot drift apart
    from repro_torch.kernels.build import LIBRARIES
    k, n = 2, 16   # one split: no partials
    Zb = torch.randn((k, C, d, n), device=dev)
    base, xi = torch.zeros((k, C, n), device=dev), torch.ones((k, n), device=dev)
    W = torch.zeros((k, d * C), device=dev)
    g = torch.empty((k, d * C), device=dev)
    K = torch.empty((k, d * C, d * C), device=dev)
    planned = nmod.newton_launch_shape(k, C, d, n)
    assert planned.splits == 1
    kind = nmod.KIND_CODES["potts" if C > 1 else "ising"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for narrow, want in ((planned.regime == "narrow", 0),
                         (planned.regime != "narrow", 1)):
        err = LIBRARIES.get("newton").repro_newton_stats(
            kind, 0, Zb.data_ptr(), base.data_ptr(), xi.data_ptr(),
            W.data_ptr(), None, None, g.data_ptr(), K.data_ptr(), k, C, d, n,
            1, n, int(narrow), stream)
        assert err == want   # 1: cudaErrorInvalidValue


@pytest.mark.parametrize("n,p", [(1001, 37), (333, 130)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_score_kernel_matches_plain(dev, kind, n, p):
    gen = torch.Generator(device=dev)
    gen.manual_seed(p)
    C = KINDS[kind]
    x = torch.randint(0, 3, (n, p), generator=gen, device=dev).float()
    F = (torch.stack([(x == c).float() for c in range(1, C + 1)])
         if kind == "potts" else (2.0 * (x > 0).float() - 1.0)[None])
    th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
    th = (th + th.transpose(1, 2)).contiguous()
    mask = (torch.rand((p, p), generator=gen, device=dev) < .1).float()
    mask = ((mask + mask.T) > 0).float()
    bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
    got = kmod.cl_score_channels(F, th, mask, bias, kind=kind)
    want = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
    for name, g, w, tol in zip(("eta", "r", "S"), got, want,
                               (1e-5, 1e-5, 1e-4)):
        assert _rel(g, w) <= tol, name


def test_score_kernel_refuses_other_types(dev):
    F = torch.ones((1, 8, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        kmod.cl_score_channels(F, F[:, :4], F[0, :4], F[:, 0],
                               kind="ising")


@pytest.mark.parametrize("family", sorted(KINDS))
def test_fit_through_kernels_matches_plain_fit(dev, family):
    g = star_graph(6) if family == "potts" else grid_graph(3, 4)
    rng = np.random.RandomState(0)
    X = rng.randint(0, 3, size=(700, g.p)).astype(np.float64)
    if family == "ising":
        X = np.where(X > 0, 1.0, -1.0)
    elif family == "gaussian":
        X = rng.randn(700, g.p)
    sess = TA.Plan(graph=g, family=family,
                   combiners=("diagonal", "optimal")).session()
    res = sess.fit(X)
    plain = sess.fit(X, use_kernel=False)
    for name in ("diagonal", "optimal"):
        np.testing.assert_allclose(res.combined[name], plain.combined[name],
                                   rtol=0, atol=1e-4)


def _qkv(dev, b, s, h, kh, d, dtype, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
    return q, k, v


@pytest.mark.parametrize("window", [0, 1, 100])
@pytest.mark.parametrize("h,kh", [(6, 2), (4, 4)])
@pytest.mark.parametrize("s,d", [(1000, 64), (130, 96), (77, 128),
                                 (200, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_matches_plain(dev, dtype, s, d, h, kh, window):
    q, k, v = _qkv(dev, 2, s, h, kh, d, dtype, seed=s + d + window)
    n0 = smod.swa_attention.launches
    got = smod.swa_attention(q, k, v, window=window)
    assert smod.swa_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    # float32: sums in another order; bfloat16: the kernel rounds p to bf16
    # for the p v product, held against the plain version in float32
    want = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                  window=window)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("s,h,kh,window", [
    (2048, 24, 8, 0),      # the prefill shape's heads and width
    (2050, 24, 8, 0),      # ragged s
    (300, 6, 2, 63),       # windows across a 64-key tile edge
    (300, 6, 2, 64),
    (300, 6, 2, 65),
    (2050, 24, 8, 1000),
])
def test_swa_bf16_pipeline_matches_plain_and_repeats(dev, s, h, kh, window):
    q, k, v = _qkv(dev, 1, s, h, kh, 128, torch.bfloat16, seed=s + window)
    got = smod.swa_attention(q, k, v, window=window)
    # no atomics: a second call is bitwise equal
    assert torch.equal(got, smod.swa_attention(q, k, v, window=window))
    want = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                  window=window)
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("s,h,kh,d,v_width", [
    (2048, 40, 40, 96, 64),   # MLA (minicpm3): nope + rope = 96, V 64 padded
    (300, 40, 40, 96, 64),
    (2048, 32, 2, 128, 0),    # glm4's 16-way group
    (300, 32, 2, 128, 0),
    (300, 40, 8, 128, 0),     # llama4-scout's 5-way group
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_at_the_attention_families_shapes(dev, dtype, s, h, kh, d,
                                                     v_width):
    q, k, v = _qkv(dev, 1, s, h, kh, d, dtype, seed=s + h + kh)
    if v_width:
        v = torch.nn.functional.pad(v[..., :v_width], (0, d - v_width))
    got = smod.swa_attention(q, k, v)
    assert torch.equal(got, smod.swa_attention(q, k, v))
    want = smod.swa_attention_ref(q.float(), k.float(), v.float())
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)
    if v_width:
        assert not got[..., v_width:].any()


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_at_the_recurrentgemma_shape(dev, dtype, window):
    # recurrentgemma's local attention: width 256 (the mma.sync kernel in
    # bf16), 10 query heads on one KV head, a window that bites
    q, k, v = _qkv(dev, 1, 300, 10, 1, 256, dtype, seed=256 + window)
    n0 = smod.swa_attention.launches
    got = smod.swa_attention(q, k, v, window=window)
    assert smod.swa_attention.launches == n0 + 1
    assert torch.equal(got, smod.swa_attention(q, k, v, window=window))
    want = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                  window=window)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("s", [1, 4, 224])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_at_the_whisper_decoder_shape(dev, dtype, s):
    # whisper-tiny's decoder self-attention: width 64, 6 query heads on 6
    # KV heads, no window, prompts from one row (shorter than every tile and
    # every bf16 TMA box) to whisper's 224 tokens of conditioning
    q, k, v = _qkv(dev, 8, s, 6, 6, 64, dtype, seed=64 + s)
    n0 = smod.swa_attention.launches
    got = smod.swa_attention(q, k, v)
    assert smod.swa_attention.launches == n0 + 1
    assert torch.equal(got, smod.swa_attention(q, k, v))
    want = smod.swa_attention_ref(q.float(), k.float(), v.float())
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_swa_kernel_reads_strided_views(dev):
    # q, k, v as slices of one fused projection: strided, not contiguous
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    qkv = torch.randn((2, 300, 8, 64), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = smod.swa_attention(q, k, v, window=50)
    want = smod.swa_attention_ref(q.float(), k.float(), v.float(), window=50)
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("k_order,v_order", [("bshd", "bshd"),
                                             ("bhsd", "bhsd"),
                                             ("bshd", "bhsd")])
def test_swa_bf16_tma_maps_both_stride_orders(dev, d, k_order, v_order):
    # the wgmma kernel reads K and V only through TMA maps: heads inside the
    # sequence (bshd), outside it (a transposed (b, h, s, d) tensor) and one
    # of each all map (a failed map raises: there is no other bf16 kernel at
    # these widths)
    b, s, h, kh = 2, 200, 6, 2
    q, k, v = _qkv(dev, b, s, h, kh, d, torch.bfloat16, seed=d)

    def lay(t, order):
        return t if order == "bshd" else \
            t.transpose(1, 2).contiguous().transpose(1, 2)
    k, v = lay(k, k_order), lay(v, v_order)
    got = smod.swa_attention(q, k, v, window=70)
    assert torch.equal(got, smod.swa_attention(q, k, v, window=70))
    want = smod.swa_attention_ref(q.float(), k.float(), v.float(), window=70)
    assert _rel(got, want) <= 1e-2


def test_swa_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 2, 2, 32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head widths"):
        smod.swa_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 16, 2, 2, 64, torch.float16, seed=0)
    with pytest.raises(TypeError):
        smod.swa_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 16, 3, 2, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        smod.swa_attention(q, k, v)
    # what it does take now: gradients, through the autograd Function (the
    # kernel forward, the plain version's recompute backward), equal to
    # plain autograd bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_(True) for t in
                   _qkv(dev, 2, 160, 6, 2, 64, dtype, seed=1))
        g = torch.randn(q.shape, device=dev).to(dtype)
        n0 = smod.swa_attention.launches
        out = swa_op(q, k, v, window=50)
        assert smod.swa_attention.launches == n0 + 1
        got = torch.autograd.grad(out, (q, k, v), g)
        want = torch.autograd.grad(
            smod.swa_attention_ref(q, k, v, window=50), (q, k, v), g)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert smod.swa_attention.launches == n0 + 1


@pytest.mark.parametrize("C,n,p", [(1, 1001, 37), (1, 333, 130),
                                   (2, 1001, 130), (3, 64, 65)])
def test_cl_logits_kernel_matches_plain(dev, C, n, p):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + p)
    F = torch.randn((C, n, p), generator=gen, device=dev)
    th = torch.randn((C, p, p), generator=gen, device=dev)
    mask = (torch.rand((p, p), generator=gen, device=dev) < .2).float()
    bias = torch.randn((C, p), generator=gen, device=dev)
    n0 = kmod.cl_logits.launches
    got = kmod.cl_logits(F, th, mask, bias)
    assert kmod.cl_logits.launches == n0 + 1
    assert _rel(got, kmod.cl_logits_ref(F, th, mask, bias)) <= 1e-5
    with pytest.raises(TypeError):
        kmod.cl_logits(F.double(), th, mask, bias)


@pytest.mark.parametrize("n,d", [(1001, 130), (4000, 64), (50, 7)])
def test_gram_kernel_matches_plain(dev, n, d):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    S = torch.randn((n, d), generator=gen, device=dev)
    n0 = gmod.gram.launches
    got = gmod.gram(S)
    assert gmod.gram.launches == n0 + 1
    # float32 sums over samples in another order
    assert _rel(got, gmod.gram_ref(S)) <= 1e-5
    with pytest.raises(TypeError):
        gmod.gram(S.double())


@pytest.mark.parametrize("n,d", [(n, d) for n in (50, 1001, 16384)
                                 for d in (7, 130, 513)]
                         + [(1, 128), (5, 512), (7, 9)])
def test_gram_kernel_ragged_is_symmetric_and_repeats(dev, n, d):
    # only the tiles on and above the diagonal run; an off-diagonal tile is
    # written to both places, so G is bitwise symmetric, and the splits are
    # summed in a fixed order, so a second call is bitwise equal; n = 1, 5
    # and 7 hold fewer samples than one pipeline slab (the copy zero-fills)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + d)
    S = torch.randn((n, d), generator=gen, device=dev)
    got = gmod.gram(S)
    assert torch.equal(got, got.T)
    assert torch.equal(got, gmod.gram(S))
    assert _rel(got, gmod.gram_ref(S)) <= 1e-5


def test_gram_kernel_reads_an_unaligned_view(dev):
    # a contiguous view one float into its storage takes the 4-byte copies
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    S = torch.randn((1001 * 128 + 1,), generator=gen, device=dev)[1:]
    S = S.view(1001, 128)
    got = gmod.gram(S)
    assert torch.equal(got, got.T)
    assert _rel(got, gmod.gram_ref(S)) <= 1e-5


def _grid_mask(dev, side):
    p = side * side
    m = torch.zeros((p, p), device=dev)
    idx = torch.arange(p, device=dev)
    right = idx[idx % side < side - 1]
    down = idx[idx // side < side - 1]
    m[right, right + 1] = m[right + 1, right] = 1.0
    m[down, down + side] = m[down + side, down] = 1.0
    return m


def _logits_inputs(dev, C, n, p, mask, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    F = torch.randn((C, n, p), generator=gen, device=dev)
    th = torch.randn((C, p, p), generator=gen, device=dev)
    bias = torch.randn((C, p), generator=gen, device=dev)
    if isinstance(mask, float):
        mask = (torch.rand((p, p), generator=gen, device=dev) < mask).float()
    return F, th, mask, bias


@pytest.mark.parametrize("mask", ["density .05", "density 1.0", "grid 16x16",
                                  "empty column", "weighted"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_cl_logits_kernel_masks_match_plain_and_repeat(dev, C, mask):
    # the product walks A's nonzeros (sparse tiles) or the union of a tile's
    # rows (dense tiles); ragged n and p divide no tile
    n, p = 333, 256 if mask == "grid 16x16" else 130
    gen = torch.Generator(device=dev)
    gen.manual_seed(C)
    if mask == "grid 16x16":
        m = _grid_mask(dev, 16)
    elif mask == "density 1.0":
        m = torch.ones((p, p), device=dev)
    elif mask == "empty column":
        m = (torch.rand((p, p), generator=gen, device=dev) < .2).float()
        m[:, 3] = 0.0
    elif mask == "weighted":
        m = torch.randn((p, p), generator=gen, device=dev) \
            * (torch.rand((p, p), generator=gen, device=dev) < .3)
    else:
        m = .05
    F, th, m, bias = _logits_inputs(dev, C, n, p, m, seed=C + p)
    got = kmod.cl_logits(F, th, m, bias)
    assert torch.equal(got, kmod.cl_logits(F, th, m, bias))
    assert _rel(got, kmod.cl_logits_ref(F, th, m, bias)) <= 1e-5
    if mask == "empty column":
        # no term at all: eta is the bias, exactly
        assert torch.equal(got[:, :, 3], bias[:, None, 3].expand(C, n))


@pytest.mark.parametrize("C", [1, 3])
def test_cl_logits_kernel_zero_mask_gives_the_bias(dev, C):
    F, th, _, bias = _logits_inputs(dev, C, 1001, 37, 0.0, seed=7)
    mask = torch.zeros((37, 37), device=dev)
    got = kmod.cl_logits(F, th, mask, bias)
    assert torch.equal(got, bias[:, None, :].expand(C, 1001, 37))


def test_cl_logits_kernel_field_grid_matches_plain(dev):
    # the field cell's mask (64 x 64 grid) at a short sample count
    F, th, _, bias = _logits_inputs(dev, 1, 300, 4096, 0.0, seed=3)
    mask = _grid_mask(dev, 64)
    got = kmod.cl_logits(F, th, mask, bias)
    assert torch.equal(got, kmod.cl_logits(F, th, mask, bias))
    assert _rel(got, kmod.cl_logits_ref(F, th, mask, bias)) <= 1e-5


def test_masked_wrappers_do_not_synchronise_with_the_host(dev):
    # the pre-pass sizes its workspace by the worst case: no count is read
    # back, so neither wrapper waits on the card
    F, th, _, bias = _logits_inputs(dev, 2, 500, 144, 0.0, seed=11)
    mask = _grid_mask(dev, 12)
    kmod.cl_logits(F, th, mask, bias)              # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kmod.cl_logits(F, th, mask, bias)
        kmod.cl_score_channels(F, th, mask, bias, kind="potts")
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_score_kernel_grid_mask_matches_plain_and_repeats(dev, kind):
    # the score kernel takes the masked product and the Gram body unchanged
    C, n, side = KINDS[kind], 1001, 12
    gen = torch.Generator(device=dev)
    gen.manual_seed(side + C)
    p = side * side
    x = torch.randint(0, 3, (n, p), generator=gen, device=dev).float()
    F = (torch.stack([(x == c).float() for c in range(1, C + 1)])
         if kind == "potts" else (2.0 * (x > 0).float() - 1.0)[None])
    th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
    th = (th + th.transpose(1, 2)).contiguous()
    mask = _grid_mask(dev, side)
    bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
    got = kmod.cl_score_channels(F, th, mask, bias, kind=kind)
    again = kmod.cl_score_channels(F, th, mask, bias, kind=kind)
    want = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g, w, tol in zip(("eta", "r", "S"), got, want,
                               (1e-5, 1e-5, 1e-4)):
        assert _rel(g, w) <= tol, name


def test_reduced_llama_on_the_card_matches_the_cpu(dev):
    cfg = TC.reduced(TC.get("llama3.2-3b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.model_init(cfg, gen, "cpu")
    params_dev = _to(params, dev)
    tok = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 100)))
    n0 = smod.swa_attention.launches
    got, _ = TT.forward(cfg, params_dev, tok.to(dev))
    assert smod.swa_attention.launches == n0 + cfg.n_layers
    want, _ = TT.forward(cfg, params, tok)
    assert _rel(got.cpu(), want) <= 1e-4
    for window in (None, 16):
        out = TD.generate(cfg, params_dev, tok[:, :40].to(dev), 8,
                          window_override=window)
        ref = TD.generate(cfg, params, tok[:, :40], 8, window_override=window)
        assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b",
                                  "recurrentgemma-2b"])
def test_reduced_attention_families_on_the_card_match_the_cpu(dev, arch):
    # minicpm3's reduced MLA attends at width 48: the kernel runs padded to
    # 64; recurrentgemma's attention layers (every third: width 64, 4/1
    # heads, window 64 < the prompt) launch it, its RG-LRU layers do not
    cfg = TC.reduced(TC.get(arch))
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)] != "rec"
                 for i in range(cfg.n_layers))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.model_init(cfg, gen, "cpu")
    params_dev = _to(params, dev)
    tok = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 100)))
    n0 = smod.swa_attention.launches
    got, aux = TT.forward(cfg, params_dev, tok.to(dev))
    assert smod.swa_attention.launches == n0 + n_attn
    want, want_aux = TT.forward(cfg, params, tok)
    assert _rel(got.cpu(), want) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * max(1.0, float(aux))
    out = TD.generate(cfg, params_dev, tok[:, :40].to(dev), 8)
    ref = TD.generate(cfg, params, tok[:, :40], 8)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("b,s,tol", [(2, 100, 1e-4), (1, 512, 3e-4)])
def test_reduced_xlstm_on_the_card_matches_the_cpu(dev, b, s, tol):
    # one chunk and two chunks of 256; no layer launches the swa kernel.
    # The long case holds tests/test_torch_xlstm.py's long-stack tolerance:
    # float32 recurrences over 16 layers, a chunk of 256 and 512 sLSTM steps
    cfg = TC.reduced(TC.get("xlstm-1.3b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.model_init(cfg, gen, "cpu")
    params_dev = _to(params, dev)
    tok = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(b, s)))
    n0 = smod.swa_attention.launches
    got, _ = TT.forward(cfg, params_dev, tok.to(dev))
    assert smod.swa_attention.launches == n0
    want, _ = TT.forward(cfg, params, tok)
    assert _rel(got.cpu(), want) <= tol
    _, cache_dev = TD.prefill(cfg, params_dev, tok.to(dev), s + 4)
    _, cache = TD.prefill(cfg, params, tok, s + 4)
    for slot, leaves in cache["units"].items():
        for key, t in leaves.items():
            assert cache_dev["units"][slot][key].dtype == t.dtype
            assert _rel(cache_dev["units"][slot][key].cpu(), t) <= tol
    out = TD.generate(cfg, params_dev, tok[:, :40].to(dev), 8)
    ref = TD.generate(cfg, params, tok[:, :40], 8)
    assert torch.equal(out.cpu(), ref)


def _reduced_whisper(dev):
    cfg = TC.reduced(TC.get("whisper-tiny"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.model_init(cfg, gen, "cpu")
    rng = np.random.RandomState(0)
    frames = torch.as_tensor(rng.randn(2, cfg.n_frames, cfg.d_model)
                             .astype(np.float32))
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 40)))
    return cfg, params, _to(params, dev), frames, tok


def test_whisper_encoder_and_cross_attention_on_the_card_match_the_cpu(dev):
    # non-causal attention takes materialised scores on the card too: no
    # swa launch, the CPU's result
    from repro_torch.models import attention as TA
    cfg, params, params_dev, frames, _ = _reduced_whisper(dev)
    n0 = smod.swa_attention.launches
    enc_dev = TT.encode(cfg, params_dev, frames.to(dev))
    enc = TT.encode(cfg, params, frames)
    assert _rel(enc_dev.cpu(), enc) <= 1e-5
    cross = {k: v[0] for k, v in params["units"]["b0"]["cross"].items()}
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    got = TA.cross_apply(cfg, _to(cross, dev), x.to(dev), enc_dev)
    want = TA.cross_apply(cfg, cross, x, enc)
    assert _rel(got.cpu(), want) <= 1e-5
    q = torch.randn(2, 7, 6, 64, device=dev)
    out = TA.sdpa(q, q, q, causal=False)
    assert not torch.allclose(out[:, 0], q[:, 0])   # row 0 sees later keys
    assert smod.swa_attention.launches == n0


def test_reduced_whisper_on_the_card_matches_the_cpu(dev):
    # the decoder's self-attention launches the kernel once a layer (width
    # 64, 4/4 heads); the encoder and the cross-attention do not
    cfg, params, params_dev, frames, tok = _reduced_whisper(dev)
    fr_dev = frames.to(dev)
    n0 = smod.swa_attention.launches
    got, _ = TT.forward(cfg, params_dev, tok.to(dev), enc_frames=fr_dev)
    assert smod.swa_attention.launches == n0 + cfg.n_layers
    want, _ = TT.forward(cfg, params, tok, enc_frames=frames)
    assert _rel(got.cpu(), want) <= 1e-4
    for s in (1, 4, 24):
        out = TD.generate(cfg, params_dev, tok[:, :s].to(dev), 8,
                          enc_frames=fr_dev)
        ref = TD.generate(cfg, params, tok[:, :s], 8, enc_frames=frames)
        assert torch.equal(out.cpu(), ref)


def test_mlstm_chunk_scan_on_the_card_matches_the_recurrence(dev,
                                                             monkeypatch):
    # xlstm-1.3b's head width 1024 and 4 heads, two chunks of 256, against
    # the chunk-1 recurrence (float32; TF32 off): normwise, sums in another
    # order through the exponential gating's normaliser
    from repro_torch.models import xlstm as TX
    gen = torch.Generator(device=dev)
    gen.manual_seed(1024)
    q, k, v = (torch.randn((1, 4, 512, 1024), generator=gen, device=dev)
               for _ in range(3))
    li = torch.randn((1, 4, 512), generator=gen, device=dev)
    lf = torch.nn.functional.logsigmoid(
        torch.randn((1, 4, 512), generator=gen, device=dev) + 1.0)
    h, state = TX._mlstm_chunk_scan(q, k, v, li, lf)
    monkeypatch.setattr(TX, "MLSTM_CHUNK", 1)
    h1, state1 = TX._mlstm_chunk_scan(q, k, v, li, lf)
    assert h.dtype == torch.float32 and h.shape == q.shape
    assert _rel(h, h1) <= 1e-4
    for a, b in zip(state, state1):
        assert _rel(a, b) <= 1e-4


def _xlstm_scan_inputs(kind):
    """Inputs of the mLSTM chunk scan (two chunks of 256 at head width 64,
    forget gates near 1 so the carried (C, n, m) weighs in) or of the
    sLSTM loop (width 128, 64 positions), and an upstream gradient on h,
    drawn on the CPU."""
    gen = torch.Generator()
    gen.manual_seed(33)
    if kind == "mlstm":
        q, k, v = (torch.randn((2, 2, 512, 64), generator=gen)
                   for _ in range(3))
        li = torch.randn((2, 2, 512), generator=gen)
        lf = torch.nn.functional.logsigmoid(
            torch.randn((2, 2, 512), generator=gen) + 5.0)
        return (q, k, v, li, lf), torch.randn((2, 2, 512, 64), generator=gen)
    zx = torch.randn((2, 64, 512), generator=gen)
    r = torch.randn((128, 512), generator=gen) * (0.5 / 128 ** 0.5)
    return (zx, r), torch.randn((2, 64, 128), generator=gen)


@pytest.mark.parametrize("kind,tol", [("mlstm", 1e-4), ("slstm", 1e-5)])
def test_xlstm_scan_gradients_on_the_card_match_the_cpu(dev, kind, tol):
    """The mLSTM chunk scan's gradients (q, k, v and both gates) and the
    sLSTM position loop's (the input gates and ``r_gates``, summed over
    every position) on the card against the CPU, float32 (TF32 off):
    normwise, sums in another order (the chunk scan's through the
    normaliser max(|q.n|, exp(-m)), as the chunk-1 test above holds it)."""
    from repro_torch.models import xlstm as TX
    ins, g = _xlstm_scan_inputs(kind)

    def scan(*a):
        if kind == "mlstm":
            return TX._mlstm_chunk_scan(*a)[0]
        return TX._slstm_scan({"r_gates": a[1]}, a[0])[0]
    grads = []
    for device in (dev, torch.device("cpu")):
        live = [t.to(device).requires_grad_(True) for t in ins]
        grads.append(torch.autograd.grad(scan(*live), live, g.to(device)))
    for got, want in zip(*grads):
        assert got.is_cuda and got.dtype == torch.float32
        assert _rel(got.cpu(), want) <= tol


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def test_reduced_train_step_on_the_card_matches_the_cpu(dev):
    """One synchronous train step of the reduced config (float32) on the
    card and on the CPU from the same state and batch: the attention kernel
    runs twice per layer (forward and the remat recompute), loss and
    gradients agree at float32 (sums in another order). Adam's first step
    is about lr * sign(g), so a coordinate whose gradient is at float32
    noise level moves by an unpredictable amount up to 2 lr: after the step
    at most 1e-4 of the parameters lie more than lr / 100 apart, and the
    others within 1e-3 of the update's size (chip_smoke.py phase 15's
    gates)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cfg = TC.reduced(TC.get("llama3.2-3b"))
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator()
    gen.manual_seed(0)
    cpu = TS.init_state(cfg, gen, "cpu")
    card = TS.TrainState(_to(cpu.params, dev),
                         adamw.init(_to(cpu.params, dev)))
    start = {k: v.clone() for k, v in cpu.params["units"]["b0"]["mlp"].items()}
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
    tcfg = TS.TrainConfig()
    n0 = smod.swa_attention.launches
    g_card, m_card = TS.grads_of(cfg, tcfg, card.params,
                                 SyntheticLM(data, dev).batch(0))
    assert smod.swa_attention.launches == n0 + 2 * cfg.n_layers
    g_cpu, m_cpu = TS.grads_of(cfg, tcfg, cpu.params,
                               SyntheticLM(data, "cpu").batch(0))
    assert abs(float(m_card["nll"]) - float(m_cpu["nll"])) \
        <= 1e-5 * float(m_cpu["nll"])
    for a, b in zip(adamw.tree_leaves(g_card), adamw.tree_leaves(g_cpu)):
        assert _rel(a.cpu(), b) <= 1e-4
    step = TS.make_train_step(cfg, ocfg, tcfg)
    step(card, SyntheticLM(data, dev).batch(0))
    step(cpu, SyntheticLM(data, "cpu").batch(0))
    apart = total = 0
    for k, p0 in start.items():
        p_card = card.params["units"]["b0"]["mlp"][k].cpu()
        p_cpu = cpu.params["units"]["b0"]["mlp"][k]
        near = (p_card - p_cpu).abs() <= ocfg.lr / 100
        apart += int((~near).sum())
        total += near.numel()
        assert _rel(p_card[near] - p0[near], p_cpu[near] - p0[near]) <= 1e-3
    assert apart <= 1e-4 * total


@pytest.mark.parametrize("weights", ["prefix", "window discount"])
@pytest.mark.parametrize("d,k,n", [(5, 333, 5007), (17, 37, 3001),
                                   (5, 4096, 1001)])
def test_weighted_newton_kernel_ragged_prox_shapes(dev, d, k, n, weights):
    """The weighted Newton kernel at the shapes a stream refit and an ADMM
    prox round give it: per-node ragged prefixes, optionally windowed and
    discounted (weights that are not 0/1)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(k + n)
    xi = torch.where(torch.rand((k, n), generator=gen, device=dev) < .5,
                     1.0, -1.0)
    Zb = torch.where(torch.rand((k, 1, d, n), generator=gen, device=dev)
                     < .5, 1.0, -1.0)
    Zb[:, :, 0] = 1.0
    base = torch.zeros((k, 1, n), device=dev)
    W = 0.1 * torch.randn((k, d), generator=gen, device=dev)
    buf = TS.SampleBuffer(1, capacity=n, device=dev)
    buf.append(torch.zeros((n, 1)))
    counts = np.random.RandomState(k).randint(0, n + 1, size=k)
    sw = (buf.prefix_masks(counts) if weights == "prefix"
          else buf.window_weights(counts, window=n // 3, discount=0.999))
    n0 = nmod.bucket_newton_stats.launches
    got = nmod.bucket_newton_stats("ising", Zb, base, xi, W, sw)
    again = nmod.bucket_newton_stats("ising", Zb, base, xi, W, sw)
    want = nmod.bucket_newton_stats_ref("ising", Zb, base, xi, W, sw)
    assert nmod.bucket_newton_stats.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(_rel(g, w) <= 1e-4 for g, w in zip(got, want))


def _ising_rows(p, n, seed):
    return np.where(np.random.RandomState(seed).rand(n, p) < .5, 1.0, -1.0)


@pytest.mark.parametrize("window", [None, 700])
def test_stream_refit_kernel_matches_plain(dev, window):
    g = grid_graph(6, 6)
    X = _ising_rows(g.p, 3000, 1)
    plan = TA.Plan(graph=g, stream_window=window)
    kern, plain = (plan.session().stream(capacity=512) for _ in range(2))
    counts = 1500 + (np.arange(g.p) * 97) % 1500
    for est in (kern, plain):
        assert est.device.type == "cuda"
        est.ingest(X[:1000])
        est.extend_pool(X[1000:])
        est.advance(counts)
    n0 = nmod.bucket_newton_stats.launches
    got = kern.refit()
    assert nmod.bucket_newton_stats.launches > n0
    n0 = nmod.bucket_newton_stats.launches
    want = plain.refit(use_kernel=False)
    assert nmod.bucket_newton_stats.launches == n0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.theta, b.theta, rtol=0, atol=1e-4)
    theta = np.zeros(plan.family_instance.n_params(g))
    s0 = kmod.cl_score_channels.launches
    assert abs(kern.score_norm(theta) - plain.score_norm(
        theta, use_kernel=False)) <= 1e-4 * plain.score_norm(
            theta, use_kernel=False)
    assert kmod.cl_score_channels.launches == s0 + 1


@pytest.mark.parametrize("family", sorted(KINDS))
def test_joint_kernel_matches_plain(dev, family):
    g = star_graph(6) if family == "potts" else grid_graph(4, 4)
    rng = np.random.RandomState(2)
    X = rng.randint(0, 3, size=(900, g.p)).astype(np.float64)
    if family == "ising":
        X = np.where(X > 0, 1.0, -1.0)
    elif family == "gaussian":
        X = rng.randn(900, g.p)
    sess = TA.Plan(graph=g, family=family, admm_iters=8).session()
    n0 = nmod.bucket_newton_stats.launches
    res = sess.joint(X)
    assert nmod.bucket_newton_stats.launches - n0 >= 8 * sess.n_buckets
    plain = sess.joint(X, use_kernel=False)
    np.testing.assert_allclose(res.trajectory, plain.trajectory, rtol=0,
                               atol=1e-4)
    assert res.primal_residual[-1] < res.primal_residual[0]


def _poisoned_inputs(dev, op, p, mask_kind, poison="F and Theta"):
    """(clean, poisoned) operands: F with NaN and +-inf at three entries
    and/or Theta with NaN and +-inf at three zeros of the mask, or (``"a row
    of F"``) every entry of one row of F +inf but one NaN. On the grid mask
    the last node has no neighbour, so its column of F is in no tile's
    union."""
    C = {"ising": 1, "gaussian": 1, "potts": 2, "logits C=1": 1,
         "logits C=3": 3}[op]
    n = 333
    gen = torch.Generator(device=dev)
    gen.manual_seed(p + C)
    x = torch.randint(0, 3, (n, p), generator=gen, device=dev).float()
    if op == "potts":
        F = torch.stack([(x == c).float() for c in range(1, C + 1)])
    elif op == "ising":
        F = (2.0 * (x > 0).float() - 1.0)[None]
    else:
        F = torch.randn((C, n, p), generator=gen, device=dev)
    th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
    if mask_kind == "grid 16x16 + isolated node":
        mask = torch.zeros((p, p), device=dev)
        mask[:256, :256] = _grid_mask(dev, 16)
    else:
        mask = (torch.rand((p, p), generator=gen, device=dev) < .05).float()
    bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
    rng = np.random.RandomState(p)
    Fp, thp = F.clone(), th.clone()
    if poison == "a row of F":
        row = Fp[C - 1, rng.randint(n)]
        row[:] = float("inf")
        row[rng.randint(p)] = float("nan")
    if poison in ("F and Theta", "F only"):
        cols = [rng.randint(p), rng.randint(p), p - 1]
        for v, j in zip((float("nan"), float("inf"), -float("inf")), cols):
            Fp[rng.randint(C), rng.randint(n), j] = v
    if poison in ("F and Theta", "Theta only"):
        zeros = torch.nonzero(mask == 0.0).cpu().numpy()
        for v, (j, i) in zip((float("nan"), float("inf"), -float("inf")),
                             zeros[rng.choice(len(zeros), 3, replace=False)]):
            thp[rng.randint(C), j, i] = v
    return (F, th, mask, bias), (Fp, thp, mask, bias)


@pytest.mark.parametrize("p,mask_kind", [
    (257, "density .05"), (257, "grid 16x16 + isolated node"),
    (100, "density .05")])
@pytest.mark.parametrize("op", ["ising", "gaussian", "potts", "logits C=1",
                                "logits C=3"])
def test_nonfinite_inputs_give_the_plain_nan_positions(dev, op, p, mask_kind):
    # eta[c, s, i] is NaN where a zero of A[:, i] meets a non-finite
    # Theta[c, :, i] or F[c, s, :], as in the plain version and the
    # reference (Theta * A first); r and S follow. p = 257 takes the
    # pre-pass (sparse walk, scan, fix-up), p = 100 the dense walk over all
    # rows. Finite eta, and r where eta and the node's own features are
    # finite, are bitwise what the clean inputs give.
    _check_nonfinite(op, *_poisoned_inputs(dev, op, p, mask_kind))


@pytest.mark.parametrize("poison,p", [
    ("Theta only", 257), ("F only", 257), ("a row of F", 1100)])
@pytest.mark.parametrize("op", ["ising", "gaussian", "potts", "logits C=1",
                                "logits C=3"])
def test_nonfinite_fixup_paths_match_plain(dev, op, poison, p):
    # the fix-up with only Theta flagged (no list of F entries), with only F
    # flagged, and with a row of F holding more non-finite entries than the
    # kernel lists at once (it then walks the row)
    _check_nonfinite(op, *_poisoned_inputs(dev, op, p, "density .05",
                                           poison))


def _check_nonfinite(op, clean, bad):
    """The kernel's NaN and +-inf positions equal the plain version's; a
    second call repeats bit for bit; finite eta, and r where eta and the
    node's own features are finite, are bitwise what ``clean`` gives."""
    if op.startswith("logits"):
        def run(args):
            return (kmod.cl_logits(*args),)

        def plain(args):
            return (kmod.cl_logits_ref(*args),)
    else:
        def run(args):
            return kmod.cl_score_channels(*args, kind=op)

        def plain(args):
            return kmod.cl_score_channels_ref(*args, op)
    got, want, ref0 = run(bad), plain(bad), run(clean)
    # a second call repeats bit for bit, NaNs included
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, run(bad)))
    assert bool(torch.isnan(got[0]).any())
    same = (torch.isfinite(got[0]) & torch.isfinite(bad[0])).all(dim=0)
    for name, g, w, c in zip(("eta", "r", "S"), got, want, ref0):
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        assert torch.equal(torch.isposinf(g), torch.isposinf(w)), name
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)), name
        fin = torch.isfinite(g)
        if name == "eta":
            assert torch.equal(g[fin], c[fin])
        elif name == "r":
            at = same.expand_as(g)
            assert torch.equal(g[at], c[at])
        if bool(fin.any()):
            assert _rel(g[fin], w[fin]) <= (1e-4 if name == "S" else 1e-5)


def _exact_samples(family, graph, theta, n, seed, q=3):
    """n exact samples of a small discrete model by enumerating its states
    (numpy only; the card machine has no reference samplers), or of the
    Gaussian MRF from its precision matrix."""
    rng = np.random.RandomState(seed)
    p, C = graph.p, (q - 1 if family == "potts" else 1)
    node = theta[: p * C].reshape(p, C)
    edge = theta[p * C:].reshape(graph.m, C)
    if family == "gaussian":
        P = np.eye(p)
        for k, (i, j) in enumerate(graph.edges):
            P[i, j] = P[j, i] = -edge[k, 0]
        cov = np.linalg.inv(P)
        return rng.multivariate_normal(cov @ node[:, 0], cov, size=n)
    vals = (-1.0, 1.0) if family == "ising" else tuple(range(q))
    states = np.array(np.meshgrid(*[vals] * p, indexing="ij")).reshape(p, -1).T
    if family == "ising":
        logp = states @ node[:, 0] + sum(
            edge[k, 0] * states[:, i] * states[:, j]
            for k, (i, j) in enumerate(graph.edges))
    else:
        ind = [(states == c).astype(float) for c in range(1, q)]
        logp = sum(ind[c] @ node[:, c] for c in range(C)) + sum(
            edge[k, c] * ind[c][:, i] * ind[c][:, j]
            for k, (i, j) in enumerate(graph.edges) for c in range(C))
    prob = np.exp(logp - logp.max())
    return states[rng.choice(len(states), size=n, p=prob / prob.sum())]


@pytest.mark.parametrize("policy", ["full", "knn"])
@pytest.mark.parametrize("family", sorted(KINDS))
def test_select_kernel_matches_plain(dev, family, policy):
    # every prox Newton iteration of every ADMM round launches the Newton
    # kernel; the plain select on the card is its yardstick
    g = grid_graph(3, 3)
    C = KINDS[family]
    rng = np.random.RandomState(7)
    theta = np.concatenate([0.2 * rng.randn(g.p * C),
                            rng.choice([-0.5, 0.5], size=g.m * C)])
    if family == "gaussian":
        theta[g.p:] *= 0.5
    X = _exact_samples(family, g, theta, 2000, seed=8)
    spec = TA.StructureSpec(policy=policy, knn_k=4, n_lambdas=6,
                            admm_rounds=20)
    sess = TA.Plan(graph=g, family=family, structure=spec).session()
    LIBRARIES.build_all()        # so the select below builds nothing
    n0 = nmod.bucket_newton_stats.launches
    res = sess.select(X)
    launched = nmod.bucket_newton_stats.launches - n0
    plain = sess.select(X, use_kernel=False)
    assert nmod.bucket_newton_stats.launches - n0 == launched
    assert launched >= len(res.lambdas)
    assert res.support == plain.support
    assert res.lambda_selected == plain.lambda_selected
    np.testing.assert_allclose(res.ebic, plain.ebic, rtol=1e-5, atol=0)
    assert res.new_compiles == 0 and res.path_compiles == 0
    cpu = TA.Plan(graph=g, family=family, structure=spec).session(
        device="cpu").select(X)
    assert cpu.candidate_edges == res.candidate_edges
    assert cpu.support == res.support
    np.testing.assert_allclose(res.lambdas, cpu.lambdas, rtol=1e-12, atol=0)


# ------------------------------------------ samplers and exact oracles
#: sampler moment error gate, in units of 1/sqrt(n) (the conformance
#: tolerances: the Gaussian's statistics are unbounded)
MOMENT_TOL = {"ising": 4.5, "gaussian": 9.0, "potts": 4.5}


def _card_gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _moment_err(fam, graph, theta, X):
    mu = fam.exact_moments(graph, theta)
    emp = fam.suff_stats(graph, X.double()).mean(0).cpu().numpy()
    return float(np.max(np.abs(emp - mu)) * np.sqrt(X.shape[0]))


@pytest.mark.parametrize("sampler", ["exact", "sequential", "chromatic",
                                     "ising", "gaussian", "potts"])
def test_samplers_on_the_card_match_exact_moments(dev, sampler):
    import repro_torch.core as TCo
    n = 16384
    if sampler in KINDS:
        fam = TCo.get_family(sampler)
        g = grid_graph(2, 3) if sampler == "potts" else grid_graph(3, 3)
        theta = fam.random_params(g, _card_gen(dev, 1))
        X = TCo.gibbs_sample_family(fam, g, theta, n, _card_gen(dev, 2),
                                    burnin=300, thin=3, n_chains=256)
    else:
        fam, g = TCo.ISING, grid_graph(3, 3)
        m = TCo.random_model(g, 0.4, 0.3, _card_gen(dev, 3))
        theta = m.theta
        gen = _card_gen(dev, 4)
        X = (TCo.exact_sample(m, n, gen) if sampler == "exact" else
             TCo.gibbs_sample(m, n, gen, burnin=300, thin=3, n_chains=256,
                              method=sampler))
    assert X.device.type == dev.type and X.shape == (n, g.p)
    assert X.dtype == torch.float32
    assert _moment_err(fam, g, theta, X) < MOMENT_TOL[fam.name]


def test_exact_oracles_on_the_card_match_the_cpu(dev):
    import repro_torch.core as TCo
    g = star_graph(8)
    m = TCo.random_model(g, 0.5, 0.5, _card_gen(dev, 5))
    mc = TCo.IsingModel(g, m.theta.cpu())
    for inc in (False, True):
        loc, loc_c = TCo.exact_locals(m, inc), TCo.exact_locals(mc, inc)
        for a, b in zip(loc, loc_c):
            for name in ("H", "V", "S", "probs"):
                np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                           rtol=0, atol=1e-10)
        for sch in ("uniform", "diagonal", "optimal", "max"):
            assert abs(TCo.exact_consensus_variance(m, loc, sch, inc)[0]
                       - TCo.exact_consensus_variance(mc, loc_c, sch,
                                                      inc)[0]) <= 1e-10
        for fn in (TCo.exact_joint_mple_variance, TCo.exact_mle_variance):
            np.testing.assert_allclose(fn(m, inc)[1], fn(mc, inc)[1],
                                       rtol=0, atol=1e-10)


def test_centralized_fits_on_the_card_match_the_cpu(dev):
    import repro_torch.core as TCo
    g = grid_graph(3, 3)
    m = TCo.random_model(g, 0.4, 0.3, _card_gen(dev, 6))
    X = TCo.exact_sample(m, 4000, _card_gen(dev, 7)).double()
    Xc = X.cpu()
    np.testing.assert_allclose(TCo.fit_mple(g, X), TCo.fit_mple(g, Xc),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(TCo.fit_mle_exact(g, X),
                               TCo.fit_mle_exact(g, Xc), rtol=0, atol=1e-8)
    res = TCo.admm_mple(g, X, n_iters=3, init="zero")
    res_c = TCo.admm_mple(g, Xc, n_iters=3, init="zero")
    np.testing.assert_allclose(res.trajectory, res_c.trajectory, rtol=0,
                               atol=1e-8)
    # the batched shim on the card launches the Newton kernel
    n0 = nmod.bucket_newton_stats.launches
    fits = TCo.fit_all_local(g, X)
    assert nmod.bucket_newton_stats.launches > n0
    loop = TCo.fit_all_local(g, Xc, method="loop")
    for a, b in zip(fits, loop):
        np.testing.assert_allclose(a.theta, b.theta, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,p", [(32, 10), (130, 128), (200, 150), (5, 260)])
@pytest.mark.parametrize("kind", ["ising", "gaussian"])
def test_seed_score_entry_points_launch_one_kernel(dev, kind, n, p):
    """cl_score, its padded and Ising variants and score_stats_op: one
    score launch per call, within the float32 precision tolerance of the
    plain version at the reference's conformance shapes."""
    import repro_torch.kernels.cl as TK
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + p)
    x = (torch.randn((n, p), generator=gen, device=dev) if kind == "gaussian"
         else torch.where(torch.rand((n, p), generator=gen, device=dev) < .5,
                          1.0, -1.0))
    theta = 0.3 * torch.randn((p, p), generator=gen, device=dev)
    theta = ((theta + theta.T) / 2).contiguous()
    mask = torch.triu((torch.rand((p, p), generator=gen, device=dev) < .3)
                      .float(), 1)
    mask = (mask + mask.T).contiguous()
    bias = 0.1 * torch.randn(p, generator=gen, device=dev)
    want = TK.cl_score_ref(x, theta, mask, bias, kind=kind)
    x_pad = torch.zeros((2 * n, p), device=dev)
    x_pad[:n] = x
    calls = [lambda: TK.cl_score(x, theta, mask, bias, kind=kind),
             lambda: TK.score_stats_op(x, theta, mask, bias, kind=kind),
             lambda: TK.cl_score_padded(x_pad, theta, mask, bias, n,
                                        kind=kind)]
    if kind == "ising":
        calls += [lambda: TK.ising_cl_score(x, theta, mask, bias),
                  lambda: TK.ising_cl_score_padded(x_pad, theta, mask, bias,
                                                   n)]
    tol = TK.precision_tolerance("float32")
    for call in calls:
        n0 = kmod.cl_score_channels.launches
        eta, r, S = call()
        assert kmod.cl_score_channels.launches == n0 + 1
        for g, w in zip((eta[:n], r[:n], S), want):
            assert g.is_cuda and float((g - w).abs().max()) <= tol
    with pytest.raises(TypeError, match="float32"):
        TK.cl_score(x.double(), theta.double(), mask.double(),
                    bias.double(), kind=kind)


def test_telemetry_fit_tags_cuda_and_equals_the_plain_off_run(dev):
    """A telemetry fit on the card: outputs bitwise those with telemetry
    off, the same launches, kernel tags with backend ``cuda`` on the cold
    fit of a fresh session and none on the warm fit."""
    g = grid_graph(8, 8)
    X = np.where(np.random.RandomState(0).rand(2048, g.p) < .5, 1.0, -1.0)
    off = TA.Plan(graph=g).session()
    on = TA.Plan(graph=g, telemetry=TA.TelemetrySpec()).session()
    counts = []
    for sess in (off, on, on):
        n0 = (nmod.bucket_newton_stats.launches,
              kmod.cl_score_channels.launches)
        res = sess.fit(X)
        counts.append((nmod.bucket_newton_stats.launches - n0[0],
                       kmod.cl_score_channels.launches - n0[1], res))
    (nl_a, sl_a, a), (nl_b, sl_b, b), (_, _, warm) = counts
    assert (nl_a, sl_a) == (nl_b, sl_b) and sl_a == 1
    np.testing.assert_array_equal(a.theta, b.theta)
    assert a.score_norm == b.score_norm
    tags = [e for e in b.telemetry.events if e["kind"] == "event"]
    assert tags and all(e["tags"]["backend"] == "cuda" for e in tags)
    assert not [e for e in warm.telemetry.events if e["kind"] == "event"]
    assert {"fit", "fit/bucket_solve", "fit/combine"} <= \
        set(b.telemetry.spans)


def _serve_on_card(plan, rows, coalesce, kind, rounds=1):
    """Every tenant's request per round through one server on the card;
    the tickets, round by round."""
    import repro_torch.serve as TSV
    srv = TSV.SessionServer(coalesce=coalesce, max_coalesce=8)
    assert srv.device.type == "cuda"
    for tid in rows:
        srv.register(tid, plan)
    out = []
    for rnd in range(rounds):
        ts = [srv.submit(tid, X[rnd], kind=kind) for tid, X in rows.items()]
        srv.drain()
        assert all(t.done for t in ts)
        out.append(ts)
    return out


@pytest.mark.parametrize("kind", ["fit", "stream"])
def test_coalesced_server_on_the_card_matches_serial(dev, kind):
    """Four tenants coalesced against the same server with coalesce=False,
    at float32: the union bucket sums each node's samples in another split
    than the tenant's own bucket, so the gate is float32-level (theta and
    every combined estimate within 1e-4 normwise)."""
    g = grid_graph(6, 6)
    plan = TA.Plan(graph=g, combiners=("diagonal", "uniform"),
                   capacity=512)
    rows = {f"t{j}": [_ising_rows(g.p, 512, 10 * j + r) for r in range(2)]
            for j in range(4)}
    rounds = 2 if kind == "stream" else 1
    co = _serve_on_card(plan, rows, True, kind, rounds)
    se = _serve_on_card(plan, rows, False, kind, rounds)
    for tc_round, ts_round in zip(co, se):
        for a, b in zip(tc_round, ts_round):
            assert a.result.coalesce_size == 4
            assert b.result.coalesce_size == 1
            assert a.result.n_samples == b.result.n_samples
            for name in plan.combiners:
                x, y = (torch.as_tensor(t.result.combined[name])
                        for t in (a, b))
                assert _rel(x, y) <= 1e-4, (name, _rel(x, y))


def test_newton_kernel_at_a_union_bucket_matches_plain(dev):
    """The kernel at a coalesced group's bucket (8 copies of a 16 x 16
    grid, whose degrees pad to one bucket: k = 2048, d = 5) against its
    plain version, and a second call bitwise equal."""
    from repro_torch.core.batched import _bucket_design, degree_buckets
    from repro_torch.serve import union_graph
    ug = union_graph(grid_graph(16, 16), 8)
    X = torch.as_tensor(_ising_rows(ug.p, 2048, 5), device=dev).float()
    b = max(degree_buckets(ug), key=lambda b: len(b.nodes))
    nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
    nbrs = torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(b.mask, device=dev)
    Zb, xi, base, _ = _bucket_design(TA.Plan(graph=ug).family_instance, X,
                                     nodes, nbrs, mask, None, True)
    assert tuple(Zb.shape) == (2048, 1, 5, 2048)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    W = 0.05 * torch.randn((Zb.shape[0], 5), generator=gen, device=dev)
    got = nmod.bucket_newton_stats("ising", Zb, base, xi, W)
    again = nmod.bucket_newton_stats("ising", Zb, base, xi, W)
    want = nmod.bucket_newton_stats_ref("ising", Zb, base, xi, W)
    assert all(_rel(g, w) <= 1e-4 for g, w in zip(got, want))
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("kind", ["fit", "stream"])
def test_coalesced_dispatch_launches_one_newton_kernel_per_iteration(
        dev, kind, monkeypatch):
    """A coalesced group's dispatch calls the engine's Newton statistics
    once per bucket per iteration for the whole group, each call one kernel
    launch (weighted for stream groups), and no plain version sees a CUDA
    tensor."""
    import repro_torch.core.batched as bmod
    from repro_torch.kernels.cl import ops as omod
    g = grid_graph(6, 6)
    plan = TA.Plan(graph=g, capacity=512)
    rows = {f"t{j}": [_ising_rows(g.p, 512, 40 + j)] for j in range(4)}
    calls, plain = [], []
    op = bmod.bucket_newton_stats_op

    def counting(kind_, Zb, base, xi, W, sw=None, **kw):
        calls.append((tuple(Zb.shape), sw is not None))
        return op(kind_, Zb, base, xi, W, sw, **kw)

    def no_plain(*args, **kw):
        plain.append(any(getattr(a, "is_cuda", False) for a in args))
        raise AssertionError("a plain version ran on the kernel path")

    monkeypatch.setattr(bmod, "bucket_newton_stats_op", counting)
    monkeypatch.setattr(omod, "bucket_newton_stats_ref", no_plain)
    n0 = nmod.bucket_newton_stats.launches
    (tickets,) = _serve_on_card(plan, rows, True, kind)
    launches = nmod.bucket_newton_stats.launches - n0
    assert tickets[0].result.coalesce_size == 4 and not plain
    assert launches == len(calls) > 0
    # every call is a bucket of the 4-copy union, weighted for streams
    shapes = {s for s, _ in calls}
    assert sum(s[0] for s in shapes) == 4 * g.p
    assert all(w == (kind == "stream") for _, w in calls)


# ---- bfloat16 operands of the score, cl_logits and gram kernels ----------
# The kernels read bfloat16 operands as they are and sum in float32, so a
# bfloat16 call gives bitwise what the float32 kernel gives on the float32
# upcasts of its operands, eta and r then rounded once (S and G float32).
# Against the plain version on the upcasts, rounded once, eta and r lie
# within one bfloat16 ulp (float32 sums in another order can round to
# neighbours), S within 1e-4 and G within 1e-5 normwise; against the plain
# version on the bfloat16 operands within PRECISION_TOLERANCES["bfloat16"]
# normwise (its cl_logits rounds the bfloat16 product before the bias).
BF16 = torch.bfloat16
BF16_SHAPES = [(32, 10), (130, 128), (200, 150), (5, 260), (1001, 37),
               (333, 130)]


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _within_one_ulp(got, want32):
    """got (bfloat16) within one ulp, plus 1e-6, of want32 rounded once."""
    want = want32.to(BF16).float()
    return bool(((got.float() - want).abs() <= _bf16_ulp(want) + 1e-6).all())


def _same_or_nan(a, b):
    """Bitwise equal values, NaN where the other is NaN (bit patterns of a
    NaN may differ between roundings)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _bf16_case(dev, kind, C, n, p, mask="sparse"):
    """bfloat16 (F, Theta, A, b) of a kind, Theta scaled so eta is O(1)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + p + C)
    x = torch.randint(0, C + 1, (n, p), generator=gen, device=dev)
    if kind == "gaussian":
        F = torch.randn((1, n, p), generator=gen, device=dev)
    elif kind == "ising":
        F = (2.0 * (x > 0).float() - 1.0)[None]
    else:
        F = torch.stack([(x == c).float() for c in range(1, C + 1)])
    if mask == "grid 16x16":
        A = _grid_mask(dev, 16)
    elif mask == "density 1.0":
        A = torch.ones((p, p), device=dev)
    else:
        d = .05 if mask == "density .05" else .1
        A = (torch.rand((p, p), generator=gen, device=dev) < d).float()
        A = ((A + A.T) > 0).float()
    deg = max(1.0, float(A.sum()) / p)
    th = torch.randn((C, p, p), generator=gen, device=dev) / deg ** 0.5
    th = ((th + th.transpose(1, 2)) / 2).contiguous()
    bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
    return tuple(t.to(BF16) for t in (F, th, A, bias))


def _check_bf16_score(kind, args):
    up = tuple(t.float() for t in args)
    n0 = kmod.cl_score_channels.launches
    got = kmod.cl_score_channels(*args, kind=kind)
    assert kmod.cl_score_channels.launches == n0 + 1
    assert [t.dtype for t in got] == [BF16, BF16, torch.float32]
    again = kmod.cl_score_channels(*args, kind=kind)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = kmod.cl_score_channels(*up, kind=kind)
    assert torch.equal(got[0], f32[0].to(BF16))
    assert torch.equal(got[1], f32[1].to(BF16))
    assert torch.equal(got[2], f32[2])
    want = kmod.cl_score_channels_ref(*up, kind)
    assert _within_one_ulp(got[0], want[0]) and _within_one_ulp(got[1],
                                                                want[1])
    assert _rel(got[2], want[2]) <= 1e-4
    tol = TK_PRECISION["bfloat16"]
    plain = kmod.cl_score_channels_ref(*args, kind)
    assert all(_rel(g, w) <= tol for g, w in zip(got, plain))


def _check_bf16_logits(args):
    up = tuple(t.float() for t in args)
    n0 = kmod.cl_logits.launches
    got = kmod.cl_logits(*args)
    assert kmod.cl_logits.launches == n0 + 1
    assert got.dtype == BF16
    assert torch.equal(got, kmod.cl_logits(*args))
    assert torch.equal(got, kmod.cl_logits(*up).to(BF16))
    assert _within_one_ulp(got, kmod.cl_logits_ref(*up))
    assert _rel(got, kmod.cl_logits_ref(*args)) <= TK_PRECISION["bfloat16"]


@pytest.mark.parametrize("n,p", BF16_SHAPES)
@pytest.mark.parametrize("kind,C", [("ising", 1), ("gaussian", 1),
                                    ("potts", 2), ("potts", 3), ("potts", 5)])
def test_score_kernel_bf16_matches_plain(dev, kind, C, n, p):
    _check_bf16_score(kind, _bf16_case(dev, kind, C, n, p))


@pytest.mark.parametrize("mask", ["density .05", "density 1.0", "grid 16x16"])
@pytest.mark.parametrize("kind,C", [("ising", 1), ("gaussian", 1),
                                    ("potts", 3)])
def test_score_kernel_bf16_masks_match_plain(dev, kind, C, mask):
    # p > 128: the pre-pass, the sparse and the dense walk
    p = 256 if mask == "grid 16x16" else 260
    _check_bf16_score(kind, _bf16_case(dev, kind, C, 333, p, mask))


@pytest.mark.parametrize("n,p", BF16_SHAPES)
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_cl_logits_kernel_bf16_matches_plain(dev, C, n, p):
    _check_bf16_logits(_bf16_case(dev, "potts" if C > 1 else "gaussian", C,
                                  n, p))


@pytest.mark.parametrize("mask", ["density .05", "density 1.0", "grid 16x16"])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_cl_logits_kernel_bf16_masks_match_plain(dev, C, mask):
    p = 256 if mask == "grid 16x16" else 260
    _check_bf16_logits(_bf16_case(dev, "potts" if C > 1 else "gaussian", C,
                                  333, p, mask))


@pytest.mark.parametrize("n,d", [(100, 7), (512, 128), (1000, 40), (3, 300),
                                 (1001, 130), (16384, 512)])
def test_gram_kernel_bf16_matches_plain(dev, n, d):
    # d % 8 == 0 takes 16-byte copies, an even d bfloat16 pairs, an odd d
    # single loads; G is float32 and bitwise the float32 kernel's on the
    # upcasts
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + d)
    S = torch.randn((n, d), generator=gen, device=dev).to(BF16)
    n0 = gmod.gram.launches
    got = gmod.gram(S)
    assert gmod.gram.launches == n0 + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, got.T) and torch.equal(got, gmod.gram(S))
    assert torch.equal(got, gmod.gram(S.float()))
    assert _rel(got, gmod.gram_ref(S.float())) <= 1e-5
    assert _rel(got, gmod.gram_ref(S)) <= TK_PRECISION["bfloat16"]


def test_gram_kernel_bf16_reads_unaligned_views(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    flat = torch.randn((1001 * 128 + 2,), generator=gen, device=dev).to(BF16)
    for off in (1, 2):   # 2-byte and 4-byte aligned bases
        S = flat[off:off + 1001 * 128].view(1001, 128)
        got = gmod.gram(S)
        assert torch.equal(got, got.T)
        assert torch.equal(got, gmod.gram(S.float()))


@pytest.mark.parametrize("p,mask_kind,poison", [
    (257, "density .05", "F and Theta"), (100, "density .05", "F and Theta"),
    (257, "grid 16x16 + isolated node", "F and Theta"),
    (257, "density .05", "Theta only"), (257, "density .05", "F only"),
    (1100, "density .05", "a row of F")])
@pytest.mark.parametrize("op", ["ising", "gaussian", "potts", "logits C=1",
                                "logits C=3"])
def test_nonfinite_bf16_inputs_give_the_plain_nan_positions(dev, op, p,
                                                           mask_kind, poison):
    # the non-finite cases of the float32 tests, in bfloat16: NaN and +-inf
    # where the plain version on the upcasts has them, every output the
    # float32 kernel's on the upcasts (rounded), a repeat bitwise
    _, bad = _poisoned_inputs(dev, op, p, mask_kind, poison)
    bad = tuple(t.to(BF16) for t in bad)
    up = tuple(t.float() for t in bad)
    if op.startswith("logits"):
        got, again = (kmod.cl_logits(*bad),), (kmod.cl_logits(*bad),)
        f32, want = (kmod.cl_logits(*up),), (kmod.cl_logits_ref(*up),)
    else:
        got = kmod.cl_score_channels(*bad, kind=op)
        again = kmod.cl_score_channels(*bad, kind=op)
        f32 = kmod.cl_score_channels(*up, kind=op)
        want = kmod.cl_score_channels_ref(*up, op)
    assert bool(torch.isnan(got[0]).any())
    for name, g, a, f, w in zip(("eta", "r", "S"), got, again, f32, want):
        assert torch.equal(g.view(torch.int16 if g.dtype == BF16
                                  else torch.int32),
                           a.view(torch.int16 if a.dtype == BF16
                                  else torch.int32)), name
        assert _same_or_nan(g, f.to(g.dtype)), name
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        assert torch.equal(torch.isposinf(g), torch.isposinf(w)), name
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)), name


@pytest.mark.parametrize("types", ["float64", "float32 F, bf16 rest",
                                   "bf16 F, float32 Theta"])
def test_kernels_refuse_float64_and_mixed_operands(dev, types):
    F, th, A, b = _bf16_case(dev, "ising", 1, 64, 37)
    args = {"float64": tuple(t.double() for t in (F, th, A, b)),
            "float32 F, bf16 rest": (F.float(), th, A, b),
            "bf16 F, float32 Theta": (F, th.float(), A, b)}[types]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kmod.cl_score_channels(*args, kind="ising")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kmod.cl_logits(*args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmod.gram(F[0].double() if types == "float64" else F[0].half())


def test_bf16_calls_allocate_only_outputs_and_scratch(dev):
    # no upcast copy of an operand: a bfloat16 call allocates its outputs
    # and the wrapper's scratch (the float32 r, the pre-pass's workspace)
    # and nothing else; a float32 copy of F would add 4 * C * n * p bytes
    C, n, p = 1, 8192, 1024
    args = _bf16_case(dev, "ising", C, n, p, "density .05")
    kmod.cl_score_channels(*args, kind="ising")   # builds and loads first
    words = kmod._workspace_words(C, p)
    splits, _ = kmod.score_launch_shape(C, n, p)
    part = splits * C * C * p * p if splits > 1 else 0
    for call, want in (
            (lambda: kmod.cl_score_channels(*args, kind="ising"),
             2 * 2 * C * n * p + 4 * C * C * p * p
             + 4 * (C * n * p + part + words)),
            (lambda: kmod.cl_logits(*args), 2 * C * n * p + 4 * words)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert extra <= want + 8 * 2**20 < want + 4 * C * n * p
        del out


# ------------------------------------------ training of the attention families
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,v_width", [(40, 64), (32, 96)])
def test_swa_function_at_width_96_equals_plain_autograd(dev, h, v_width,
                                                        dtype):
    """The training shapes at width 96: minicpm3's MLA (40/40 heads, V
    zero-padded from 64) and phi3 (32/32). One forward launch, and dq, dk,
    dv bit for bit those of plain autograd (the backward recomputes
    through the plain version)."""
    q, k, v = _qkv(dev, 2, 300, h, h, 96, dtype, seed=h)
    v = torch.nn.functional.pad(v[..., :v_width], (0, 96 - v_width))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    g = torch.randn(q.shape, device=dev).to(dtype)
    n0 = smod.swa_attention.launches
    out = swa_op(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert smod.swa_attention.launches == n0 + 1
    want = torch.autograd.grad(smod.swa_attention_ref(q, k, v), (q, k, v), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        ref = smod.swa_attention_ref(q.float(), k.float(), v.float())
    assert _rel(out.detach(), ref) <= (1e-2 if dtype == torch.bfloat16
                                       else 1e-5)
    assert not out[..., v_width:].any()      # V's padding stays zero


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 64, 2048])
def test_swa_function_at_the_recurrentgemma_width_equals_plain_autograd(
        dev, window, dtype):
    """recurrentgemma's training attention: width 256 (the mma.sync kernel
    in bf16), 10 query heads on one KV head, 2100 tokens so its window of
    2048 bites. One forward launch, and dq, dk, dv bit for bit those of
    plain autograd with the window."""
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(dev, 1, 2100, 10, 1, 256, dtype, seed=2100 + window))
    g = torch.randn(q.shape, device=dev).to(dtype)
    n0 = smod.swa_attention.launches
    out = swa_op(q, k, v, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert smod.swa_attention.launches == n0 + 1
    want = torch.autograd.grad(smod.swa_attention_ref(q, k, v, window=window),
                               (q, k, v), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        ref = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                     window=window)
    assert _rel(out.detach(), ref) <= (1e-2 if dtype == torch.bfloat16
                                       else 1e-5)


def test_swa_function_at_the_whisper_width_equals_plain_autograd(dev):
    """whisper-tiny's decoder self-attention in training: width 64 (the
    wgmma kernel, K and V by TMA), 6/6 heads, bf16, 2 x 3000 tokens (no
    multiple of a tile). One forward launch, and dq, dk, dv bit for bit
    those of plain autograd."""
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(dev, 2, 3000, 6, 6, 64, torch.bfloat16, seed=3000))
    g = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    n0 = smod.swa_attention.launches
    out = swa_op(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert smod.swa_attention.launches == n0 + 1
    want = torch.autograd.grad(smod.swa_attention_ref(q, k, v), (q, k, v), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        ref = smod.swa_attention_ref(q.float(), k.float(), v.float())
    assert _rel(out.detach(), ref) <= 1e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["float32", "bfloat16"])
def test_full_attention_gradients_on_the_card_match_the_cpu(dev, dtype, tol):
    """The encoder's and the cross-attention's non-causal attention
    (``_full_attention``: materialised scores, the float32 softmax cast
    back to the operands' type) at 300 queries over 200 keys, 6 heads of
    64: output and dq, dk, dv on the card against the CPU from the same
    inputs, in the operands' type (float32 sums in another order, TF32
    off; in bf16 each side's products round to bf16 on their own)."""
    from repro_torch.models import attention as TMA
    gen = torch.Generator()
    gen.manual_seed(300)
    q, g = (torch.randn((2, 300, 6, 64), generator=gen).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((2, 200, 6, 64), generator=gen).to(dtype)
            for _ in range(2))
    results = []
    for where in (dev, "cpu"):
        ins = [t.to(where).requires_grad_(True) for t in (q, k, v)]
        out = TMA._full_attention(*ins)
        grads = torch.autograd.grad(out, ins, g.to(where))
        assert out.dtype == dtype and all(x.dtype == dtype for x in grads)
        results.append([t.detach().cpu() for t in (out, *grads)])
    assert all(_rel(a, b) <= tol for a, b in zip(*results))


def test_kernel_attention_padded_width_gradients_match_plain(dev):
    """The reduced MLA width 48 runs the kernel zero-padded to 64 with q
    scaled by sqrt(64 / 48): output and gradients against plain autograd
    at 48 unpadded (float32 sums in another order)."""
    from repro_torch.models import attention as TMA
    q, k, v = _qkv(dev, 2, 200, 4, 4, 48, torch.float32, seed=48)
    g = torch.randn(q.shape, device=dev)
    for window in (0, 64):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = smod.swa_attention.launches
        out = TMA._kernel_attention(*ins, window=window)
        assert smod.swa_attention.launches == n0 + 1
        got = torch.autograd.grad(out, ins, g)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = TMA._plain_attention(*plain, window=window)
        want = torch.autograd.grad(ref, plain, g)
        assert _rel(out.detach(), ref.detach()) <= 1e-5
        assert all(_rel(a, b) <= 1e-5 for a, b in zip(got, want))


def _family_state(arch, seed, **changes):
    import dataclasses

    from repro_torch.train import step as TS
    cfg = dataclasses.replace(TC.reduced(TC.get(arch)), **changes)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return cfg, TS.init_state(cfg, gen, "cpu")


@pytest.mark.parametrize("arch,grad_tol,flips", [
    ("qwen2-moe-a2.7b", 1e-4, 1e-4), ("minicpm3-4b", 1e-4, 1e-4),
    ("recurrentgemma-2b", 1e-4, 1e-4), ("xlstm-1.3b", 4.5e-3, 7.8e-4),
    ("whisper-tiny", 1e-4, 1e-4)],
    ids=["qwen2-moe-a2.7b", "minicpm3-4b", "recurrentgemma-2b",
         "xlstm-1.3b", "whisper-tiny"])
def test_reduced_family_train_step_on_the_card_matches_the_cpu(
        dev, arch, grad_tol, flips):
    """One train step of the reduced expert, MLA, RG-LRU, xLSTM and
    whisper configs (float32; recurrentgemma's 128 tokens pass its window
    of 64, xLSTM's are one chunk, whisper's batch carries all 16 frame
    embeddings) on the card and on the CPU from one state and batch,
    under the gates of
    ``test_reduced_train_step_on_the_card_matches_the_cpu``: two kernel
    launches an attention layer (none in the xLSTM), nll and aux,
    gradients within ``grad_tol``, and the step's
    parameters (at most ``flips`` of them more than lr / 100 apart, the
    others within 1e-3 of the update). The xLSTM's float32 gradients at
    initialisation sit 1e-4 to 1.5e-3 from float64 whichever float32 run
    computes them (its backward grows about 300-fold from the head to the
    embedding), so its gates are ``chip_smoke.py``'s GATE_XL_TRAIN_GRAD
    and GATE_XL_TRAIN_FLIPS: this state reads 1.3e-3 and 2.3e-4 on the
    card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cfg, cpu = _family_state(arch, 1)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    card = TS.TrainState(_to(cpu.params, dev),
                         adamw.init(_to(cpu.params, dev)))
    start = [t.clone() for t in adamw.tree_leaves(cpu.params)]
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
    tcfg = TS.TrainConfig()
    gen = torch.Generator()
    gen.manual_seed(2)
    frames = torch.randn((2, cfg.n_frames, cfg.d_model), generator=gen)

    def batch(where):
        out = SyntheticLM(data, where).batch(0)
        if cfg.enc_dec:
            out["enc_frames"] = frames.to(where)
        return out
    n0 = smod.swa_attention.launches
    g_card, m_card = TS.grads_of(cfg, tcfg, card.params, batch(dev))
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)] in ("attn", "attn_moe",
                                                       "xattn")
                 for i in range(cfg.n_layers))
    assert smod.swa_attention.launches == n0 + 2 * n_attn
    g_cpu, m_cpu = TS.grads_of(cfg, tcfg, cpu.params, batch("cpu"))
    for key in ("nll", "aux"):
        assert abs(float(m_card[key]) - float(m_cpu[key])) \
            <= 1e-5 * max(float(m_cpu[key]), 1.0)
    for a, b in zip(adamw.tree_leaves(g_card), adamw.tree_leaves(g_cpu)):
        assert _rel(a.cpu(), b) <= grad_tol
    step = TS.make_train_step(cfg, ocfg, tcfg)
    step(card, batch(dev))
    step(cpu, batch("cpu"))
    apart = total = 0
    for p0, p_card, p_cpu in zip(start, adamw.tree_leaves(card.params),
                                 adamw.tree_leaves(cpu.params)):
        p_card = p_card.cpu()
        near = (p_card - p_cpu).abs() <= ocfg.lr / 100
        apart += int((~near).sum())
        total += near.numel()
        assert _rel(p_card[near] - p0[near], p_cpu[near] - p0[near]) <= 1e-3
    assert apart <= flips * total


def test_reduced_expert_step_repeats_bitwise_on_the_card(dev):
    """The expert layer's backward on the capacity path (4224 tokens, pairs
    dropped) takes no atomics that reorder sums: the gradients of one
    state and batch are bitwise equal from one call to the next."""
    from repro_torch.models import moe as TMOE
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cfg, cpu = _family_state("qwen2-moe-a2.7b", 2, capacity_factor=0.5)
    params = _to(cpu.params, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (16, 264), generator=gen,
                        device=dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    assert tok.numel() > TMOE.DROPLESS_TOKENS
    first = TS.grads_of(cfg, TS.TrainConfig(), params, batch)
    again = TS.grads_of(cfg, TS.TrainConfig(), params, batch)
    assert all(torch.equal(a, b) for a, b in
               zip(adamw.tree_leaves(first[0]), adamw.tree_leaves(again[0])))
    assert all(torch.equal(first[1][k], again[1][k]) for k in first[1])
