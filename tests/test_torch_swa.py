"""The port's plain flash-attention version against the JAX package: its
materialised-score oracle and its Pallas kernel run in interpret mode, on
the same numpy inputs, at float32. On a CPU tensor the kernel wrapper and
the dispatch take the plain version and count no launch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa.kernel import swa_attention as j_swa  # noqa: E402
from repro.kernels.swa.ref import swa_attention_ref as j_swa_ref  # noqa: E402
from repro_torch.kernels.swa import kernel as smod  # noqa: E402
from repro_torch.kernels.swa.ops import swa_op  # noqa: E402
from repro_torch.kernels.swa.ref import swa_attention_ref  # noqa: E402

# float32 sums taken in another order (and, against the kernel, an online
# softmax against a one-pass one): a few units in the last place of O(1)
TOL = 2e-6


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, n, d).astype(np.float32)
                 for n in (h, kh, kh))


@pytest.mark.parametrize("window", [0, 5, 16])
@pytest.mark.parametrize("kh", [4, 2, 1])
@pytest.mark.parametrize("s", [37, 130])
def test_plain_swa_matches_reference_oracle_and_interpret_kernel(s, kh,
                                                                 window):
    q, k, v = _inputs(2, s, 4, kh, 32, seed=s + kh + window)
    got = swa_attention_ref(*map(torch.as_tensor, (q, k, v)),
                            window=window).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    for want in (j_swa_ref(q, k, v, window=window),
                 j_swa(q, k, v, window=window, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_window_one_attends_to_the_diagonal_only():
    q, k, v = _inputs(1, 9, 2, 1, 32, seed=0)
    got = swa_attention_ref(*map(torch.as_tensor, (q, k, v)), window=1)
    np.testing.assert_allclose(got.numpy(), np.repeat(v, 2, axis=2),
                               rtol=0, atol=1e-7)


def test_plain_swa_in_bfloat16_rounds_like_the_reference():
    q, k, v = _inputs(1, 40, 4, 2, 32, seed=3)
    qb, kb, vb = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = swa_attention_ref(qb, kb, vb, window=8)
    assert got.dtype == torch.bfloat16
    want = j_swa_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     window=8)
    # both round the scores' einsum and p to bf16; the sums differ in order
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)


def test_wrapper_and_dispatch_on_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.as_tensor, _inputs(2, 20, 4, 2, 32, seed=1))
    n0 = smod.swa_attention.launches
    want = swa_attention_ref(q, k, v, window=6)
    assert torch.equal(smod.swa_attention(q, k, v, window=6), want)
    assert torch.equal(swa_op(q, k, v, window=6), want)
    assert smod.swa_attention.launches == n0
