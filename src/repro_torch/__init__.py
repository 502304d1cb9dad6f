"""PyTorch / CUDA port of the distributed pseudo-likelihood estimator.

The JAX package ``repro`` is the reference; this package carries the same
public API (``Plan(...).session()`` and its ``fit``, ``stream``,
``simulate``, ``joint`` and ``select`` verbs) on PyTorch, and the serving
path of the reference's dense GQA transformers (:mod:`repro_torch.models`,
:mod:`repro_torch.configs`), with every TPU kernel rewritten as a CUDA
kernel for Hopper (``csrc/``). It imports neither ``jax`` nor ``repro``.

    import repro_torch.api as A
    res = A.Plan(graph=g, family="ising", combiners=("diagonal",)
                 ).session().fit(X)          # on the CUDA card
    res = plan.session(device="cpu").fit(X)  # plain PyTorch on the CPU
"""
