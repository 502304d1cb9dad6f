"""Streaming any-time estimation and the event-driven sensor-network
simulator, on the port's device.

Samples arrive at sensors over time (:class:`ArrivalSpec`); per-node online
estimators re-fit incrementally by warm-starting the batched Newton engine
over a shape-stable sample buffer on the device
(:class:`StreamingEstimator`); estimates flow over an explicit lossy, laggy
message network (:class:`Network`); and :class:`StreamSimulator` traces
error-vs-samples and error-vs-scalars trajectories, queryable at any round
via ``StreamResult.estimate_at(t)``, with one-step or streaming-ADMM
estimators and crash, Byzantine and replay faults (:class:`FaultPlan`).
Communication accounting (:mod:`repro_torch.stream.costs`) is the
reference's.
"""
from .buffer import SampleBuffer
from .costs import (SCHEME_SCALARS_PER_PARAM, admm_message_scalars,
                    comm_costs, one_step_message_scalars)
from .faults import (BYZANTINE_KINDS, ByzantineSpec, CrashSpec, DriftSpec,
                     FaultPlan, ReplaySpec)
from .network import Message, Network, NetworkConfig
from .online import StreamingEstimator, pseudo_score
from .simulator import (ONE_STEP_SCHEMES, ArrivalSpec, StreamResult,
                        StreamSimulator)
