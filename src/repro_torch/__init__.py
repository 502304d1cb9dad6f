"""PyTorch / CUDA port of the distributed pseudo-likelihood estimator.

The JAX package ``repro`` is the reference; this package carries the same
public API (``Plan(...).session().fit(X)``) on PyTorch, with the TPU kernels
of the fit path rewritten as CUDA kernels for Hopper (``csrc/``). It imports
neither ``jax`` nor ``repro``.

    import repro_torch.api as A
    res = A.Plan(graph=g, family="ising", combiners=("diagonal",)
                 ).session().fit(X)          # on the CUDA card
    res = plan.session(device="cpu").fit(X)  # plain PyTorch on the CPU
"""
