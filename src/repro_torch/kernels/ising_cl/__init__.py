"""Import shims for the seed's ``ising_cl`` package: every name lives in
:mod:`repro_torch.kernels.cl`.

The reference's ``kernel`` and ``score`` shims also export its Pallas
tile sizes ``BM``, ``BN`` and ``BK``. The port has no counterpart: its
kernels take no tile arguments, and their launch shapes follow fixed rules
(``kernels/cl/kernel.py::score_launch_shape``, ``kernels/cl/newton.py::
newton_launch_shape``) until a tuner searches them.
"""
