"""The CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip with a reason.
Run them on a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as TA  # noqa: E402
from repro_torch.core import grid_graph, star_graph  # noqa: E402
from repro_torch.kernels.cl import kernel as kmod  # noqa: E402
from repro_torch.kernels.cl import newton as nmod  # noqa: E402

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
