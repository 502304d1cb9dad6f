"""Event-driven sensor-network simulator with an any-time query API.

Discrete rounds; each round:

  1. every sensor's arrival process delivers new samples from the
     environment pool (heterogeneous rates supported);
  2. the online estimator bank re-fits (warm-started, incremental) on a
     configurable cadence, or, in ADMM mode, every node takes one proximal
     primal step (Sec. 3.2) on its current data; on the card both run the
     Newton kernel once per Newton iteration;
  3. fresh estimates of *shared* parameters travel to neighbor sensors as
     explicit messages through the :class:`~repro_torch.stream.network.
     Network` (link schedules, drops, delays; every scalar is counted);
  4. each parameter's home sensor combines whatever owner estimates have
     arrived (possibly stale) with the paper's one-step weighting schemes,
     or, in ADMM mode, updates its consensus average and dual variable.

``run`` records an error/communication trajectory; ``StreamResult.
estimate_at(t)`` answers "what would the network report if queried at round
t". The port carries crash, Byzantine, replay and drift faults; a drift
change-point jumps the truth and re-draws the unseen pool from the drifted
model with ``family.exact_sample``, keyed statelessly off the seed and the
change-point round. With ``telemetry=`` (a ``TelemetrySpec``, a session's
recorder, or None) a run records ``stream`` / ``round`` / ``refit`` spans,
the network's message counters, fault and combiner counters, and the
timeline points that ``StreamResult.timeline`` reads first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.asymptotics import free_indices, param_owners
from ..core.batched import prox_update_batched
from ..core.combiners import (TRUST_RADIUS, get_combiner,
                              streamable_combiners)
from ..core.graphs import Graph
from ..telemetry.recorder import make_recorder
from .buffer import as_device_rows
from .costs import admm_message_scalars, one_step_message_scalars
from .faults import FaultPlan
from .network import (Message, Network, NetworkConfig, rng_state_from_json,
                      rng_state_to_json)
from .online import StreamingEstimator


def _one_step_schemes() -> Tuple[str, ...]:
    """Streamable one-step schemes, resolved from the live combiner
    registry: distributable as one message round and able to fuse
    (estimate, variance) candidates receiver-side."""
    return tuple(c.name for c in streamable_combiners())


#: import-time snapshot of the built-in streamable schemes
ONE_STEP_SCHEMES = _one_step_schemes()


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Per-round, per-node sample arrival process.

    kind — "fixed" (exactly ``rate`` samples each round), "poisson"
    (Poisson(``rate``)), or "bursty" (a burst of ``burst`` samples with
    probability ``rate/burst``, same mean as the others). ``rate`` may be a
    scalar or a length-p tuple for sensors sampling at different speeds.
    """
    kind: str = "fixed"
    rate: object = 1.0
    burst: int = 8

    def draw(self, rng: np.random.RandomState, p: int) -> np.ndarray:
        rate = np.broadcast_to(np.asarray(self.rate, dtype=np.float64), (p,))
        if self.kind == "fixed":
            return np.round(rate).astype(np.int64)
        if self.kind == "poisson":
            return rng.poisson(rate).astype(np.int64)
        if self.kind == "bursty":
            prob = np.minimum(1.0, rate / max(self.burst, 1))
            return (rng.binomial(1, prob) * self.burst).astype(np.int64)
        raise ValueError(f"unknown arrival kind {self.kind!r}")


@dataclasses.dataclass
class StreamResult:
    """Recorded trajectory of one simulation; the any-time query surface."""
    rounds: np.ndarray        # (R,) round indices of the snapshots
    theta: np.ndarray         # (R, n_params) combined estimate per snapshot
    samples_seen: np.ndarray  # (R,) mean samples per node
    samples_total: np.ndarray  # (R,) total samples across nodes
    scalars_sent: np.ndarray  # (R,) cumulative scalars transmitted
    err: Optional[np.ndarray]         # (R,) MSE vs theta_star (if given)
    score_norm: Optional[np.ndarray]  # (R,) pseudo-likelihood score norm
    staleness: np.ndarray     # (R,) mean age (rounds) of received views
    #: what the network reported when recording started (theta_fixed for a
    #: fresh simulator); answers queries earlier than the first snapshot
    initial: Optional[np.ndarray] = None
    #: :class:`repro_torch.telemetry.TelemetrySnapshot` of the run's events
    #: when the simulator carried a live recorder, else None
    telemetry: Optional[object] = None

    #: recorded columns addressable through :meth:`timeline`
    _COLUMNS = ("err", "scalars_sent", "samples_seen", "samples_total",
                "staleness", "score_norm")

    def timeline(self, metric: str) -> Tuple[np.ndarray, np.ndarray]:
        """(rounds, values) any-time curve for one recorded metric: the
        telemetry snapshot's ``point`` events when a live recorder captured
        them (equal to a JSONL replay), else the result's own recorded
        column (``err`` / ``scalars_sent`` / ``samples_seen`` /
        ``samples_total`` / ``staleness`` / ``score_norm``)."""
        if self.telemetry is not None and metric in self.telemetry.points:
            return self.telemetry.timeline(metric)
        if metric not in self._COLUMNS:
            raise KeyError(
                f"unknown timeline metric {metric!r}; have "
                f"{sorted(self._COLUMNS)}")
        col = getattr(self, metric)
        if col is None:
            raise KeyError(
                f"metric {metric!r} was not recorded for this run "
                f"(pass theta_star / record_score to the simulator)")
        return (np.asarray(self.rounds, dtype=np.int64),
                np.asarray(col, dtype=np.float64))

    def estimate_at(self, t: int) -> np.ndarray:
        """Combined theta as of round ``t``: the last snapshot at or before
        t; a query earlier than the first snapshot returns ``initial`` (or
        the earliest snapshot when ``initial`` was not recorded)."""
        idx = int(np.searchsorted(self.rounds, t, side="right")) - 1
        if idx < 0:
            if self.initial is not None:
                return self.initial
            return self.theta[0]
        return self.theta[idx]


def _guard(est: float, w: float) -> bool:
    """Same sanity guard as the combiners' bad-owner logic."""
    return bool(np.isfinite(est) and np.isfinite(w)
                and abs(est) <= TRUST_RADIUS)


class StreamSimulator:
    """Streaming distributed estimation over an explicit message network.

    Parameters
    ----------
    graph : the conditional-independence graph == the sensor network.
    pool : (N, p) pre-drawn environment samples (numpy or a tensor); they
        are held as float32 on ``device`` and arrivals reveal prefixes.
    estimator : "one_step" (online local fits + one-step consensus of
        whatever has arrived) or "admm" (streaming ADMM: one warm-started
        proximal round per simulator round over the growing buffers).
    scheme : one-step weighting, any *streamable* combiner from the
        registry (``ONE_STEP_SCHEMES``); the receiver-side fusion
        dispatches through the strategy object's ``combine_candidates``.
    device : where the pool, the buffers and every solve live (the CUDA
        card when None).

    ``StreamSimulator.from_plan(plan, pool, ...)`` configures all of the
    above from a declarative :class:`repro_torch.api.Plan`.
    """

    def __init__(self, graph: Graph, pool, *,
                 estimator: str = "one_step", scheme: str = "diagonal",
                 theta_star: Optional[np.ndarray] = None,
                 include_singleton: bool = True,
                 theta_fixed: Optional[np.ndarray] = None,
                 network: Optional[NetworkConfig] = None,
                 arrivals: ArrivalSpec = ArrivalSpec(rate=8.0),
                 refit_every: int = 1, newton_iters: int = 40,
                 admm_rho: float = 1.0, capacity: int = 64,
                 seed: int = 0, family=None,
                 faults: Optional[FaultPlan] = None,
                 window: Optional[int] = None,
                 discount: Optional[float] = None,
                 telemetry=None, device=None) -> None:
        if estimator not in ("one_step", "admm"):
            raise ValueError(f"unknown estimator {estimator!r}")
        streamable = _one_step_schemes()
        if scheme not in streamable:
            raise ValueError(
                f"unknown streaming scheme {scheme!r}; streamable "
                f"combiners: {list(streamable)}")
        if faults is not None and not isinstance(faults, FaultPlan):
            raise TypeError(f"faults must be a FaultPlan, "
                            f"got {type(faults).__name__}")
        from ..core.families import ISING
        #: telemetry recorder threaded through the estimator bank, the
        #: network and the round loop (a TelemetrySpec, an existing
        #: Recorder such as the owning session's, or None for the shared
        #: null recorder)
        self.recorder = make_recorder(telemetry)
        self.combiner = get_combiner(scheme)
        #: unit weights are implicit and never transmitted (uniform)
        self._sends_weight = self.combiner.scalars_per_shared_param >= 2
        self.graph = graph
        self.family = ISING if family is None else family
        self.faults = faults if faults is not None and not faults.empty \
            else None
        if self.faults is not None:
            for spec in (self.faults.crashes + self.faults.byzantine):
                if spec.node >= graph.p:
                    raise ValueError(
                        f"fault spec names node {spec.node}, but the "
                        f"graph has only {graph.p} nodes (0.."
                        f"{graph.p - 1})")
            if self.faults.drift and theta_star is None:
                raise ValueError(
                    "parameter drift needs theta_star (the truth to "
                    "perturb); pass theta_star= to the simulator")
        self.est = StreamingEstimator(graph, include_singleton, theta_fixed,
                                      capacity=capacity, n_iter=newton_iters,
                                      family=self.family,
                                      want_influence=False,
                                      window=window, discount=discount,
                                      device=device, recorder=self.recorder)
        #: the environment pool, float32 on the simulator's device
        self.pool = self._own_pool(pool)
        self.estimator = estimator
        self.scheme = scheme
        self.include_singleton = include_singleton
        self.theta_fixed = (np.zeros(self.family.n_params(graph))
                            if theta_fixed is None
                            else np.asarray(theta_fixed, dtype=np.float64))
        self.theta_star = (None if theta_star is None
                           else np.asarray(theta_star, dtype=np.float64))
        self.free = np.asarray(free_indices(graph, include_singleton,
                                            self.family))
        self.arrivals = arrivals
        self.refit_every = max(int(refit_every), 1)
        self.newton_iters = newton_iters
        # one seed: arrivals, network, fault draws and drift each get an
        # independent stream derived from it
        self.seed = int(seed)
        s_arr, s_net, s_fault, s_drift = (
            int(v) for v in np.random.SeedSequence(self.seed)
            .generate_state(4))
        self._arr_rng = np.random.RandomState(s_arr)
        self._fault_rng = np.random.RandomState(s_fault)
        self._drift_seed = s_drift

        links = [(i, j) for (a, b) in graph.edges for (i, j) in ((a, b),
                                                                (b, a))]
        self.net = Network(links, network or NetworkConfig(),
                           rng=np.random.RandomState(s_net),
                           recorder=self.recorder)
        # params shared between the endpoints of each directed link: exactly
        # the link's own edge-coupling block (beta_i ∩ beta_j, Sec. 3.1)
        owners = param_owners(graph, include_singleton, self.family)
        self._shared: Dict[Tuple[int, int], List[int]] = {
            (i, j): [] for (i, j) in links}
        for a in sorted(owners):
            nodes = sorted({node for node, _ in owners[a]})
            for i in nodes:
                for j in nodes:
                    if (i, j) in self._shared:
                        self._shared[(i, j)].append(a)
        self._owners = owners
        # (dst, src) -> {"vals": {a: (est, weight)}, "version", "sent_round"}
        self._view: Dict[Tuple[int, int], Dict] = {}
        self._last_sent = {link: -1 for link in links}
        # per-link previous payload: what a replay attack re-injects
        self._last_payload: Dict[Tuple[int, int], Dict] = {}
        self.round = 0
        self._fed = 0

        if estimator == "admm":
            betas = [self.family.beta(graph, i, include_singleton)
                     for i in range(graph.p)]
            self._betas = betas
            self._admm_theta = [self.theta_fixed[np.asarray(b)].copy()
                                for b in betas]
            self._admm_lam = [np.zeros(len(b)) for b in betas]
            self._admm_rho = [np.full(len(b), float(admm_rho))
                              for b in betas]
            self._admm_bar = [self.theta_fixed[np.asarray(b)].copy()
                              for b in betas]

    # ---------------------------------------------------------- plan entry
    @classmethod
    def from_plan(cls, plan, pool, *, estimator: str = "one_step",
                  **overrides) -> "StreamSimulator":
        """Build a simulator from a declarative :class:`repro_torch.api.
        Plan`: graph, family, singleton policy, fixed coordinates, buffer
        capacity, Newton budgets (``n_iter`` for one-step re-fits,
        ``admm_newton_iters``/``admm_rho`` for streaming ADMM), faults,
        window and discount, and the scheme (the first *streamable*
        combiner the plan requests). ``overrides`` win over the
        constructor arguments (e.g. ``theta_star=``, ``arrivals=``,
        ``network=``, ``seed=``, ``device=``).
        """
        streamable = _one_step_schemes()
        scheme = next((n for n in plan.combiners if n in streamable), None)
        if scheme is None and estimator == "one_step":
            raise ValueError(
                f"plan requests no streamable combiner "
                f"({list(plan.combiners)}); streamable: "
                f"{list(streamable)}")
        kwargs = dict(
            estimator=estimator, scheme=scheme or "diagonal",
            include_singleton=plan.include_singleton,
            theta_fixed=(None if plan.theta_fixed is None
                         else np.asarray(plan.theta_fixed,
                                         dtype=np.float64)),
            newton_iters=(plan.n_iter if estimator == "one_step"
                          else plan.admm_newton_iters),
            admm_rho=plan.admm_rho, capacity=plan.capacity,
            family=plan.family_instance, faults=plan.faults,
            window=plan.stream_window, discount=plan.stream_discount,
            telemetry=plan.telemetry)
        kwargs.update(overrides)
        return cls(plan.graph, pool, **kwargs)

    # ------------------------------------------------------------- stepping
    def _down_now(self, rnd: int) -> np.ndarray:
        """(p,) crash mask for this round from the fault plan."""
        if self.faults is None or not self.faults.crashes:
            return np.zeros(self.graph.p, dtype=bool)
        return np.array([self.faults.crashed(i, rnd)
                         for i in range(self.graph.p)])

    def _own_pool(self, pool) -> torch.Tensor:
        """``pool`` as float32 rows on the simulator's device. Drift
        re-draws the unseen tail in place, and ``as_device_rows`` may hand
        back the caller's own storage, so with drift the simulator keeps a
        private copy."""
        rows = as_device_rows(pool, torch.float32, self.est.device)
        if self.faults is not None and self.faults.drift:
            rows = rows.clone()
        return rows

    def _drift_draw(self, spec, tail: int):
        """The draws of one change-point: the (len(free),) float64 jump,
        from a CPU generator so the truth does not depend on the device,
        and ``tail`` rows from the drifted model on the pool's device.
        Both generators are seeded from (drift seed, ``spec.at``) alone.
        Returns (the drifted theta_star, rows)."""
        s_delta, s_rows = np.random.SeedSequence(
            [self._drift_seed, int(spec.at)]).generate_state(2)
        gen = torch.Generator()
        gen.manual_seed(int(s_delta))
        delta = spec.scale * torch.randn(len(self.free), generator=gen,
                                         dtype=torch.float64).numpy()
        theta = self.theta_star.copy()
        theta[self.free] += delta
        rows = None
        if tail > 0:
            dev = self.pool.device
            gen_rows = torch.Generator(device=dev)
            gen_rows.manual_seed(int(s_rows))
            rows = self.family.exact_sample(
                self.graph, torch.as_tensor(theta, device=dev), tail,
                gen_rows)
        return theta, rows

    def _apply_drift(self, spec) -> None:
        """Change-point: jump theta_star at the free coordinates and
        re-draw the unseen pool tail from the drifted model; rows already
        fed keep their values. Keyed statelessly off the drift stream and
        the change-point round, so a restored simulator that already
        passed the change-point needs no extra RNG state."""
        tail = len(self.pool) - self._fed
        theta, rows = self._drift_draw(spec, tail)
        self.theta_star = np.asarray(theta, dtype=np.float64)
        if tail > 0:
            self.pool[self._fed:] = torch.as_tensor(rows).to(
                device=self.pool.device, dtype=torch.float32)

    def step(self) -> None:
        rnd = self.round
        p = self.graph.p
        rec = self.recorder
        with rec.span("round", round=rnd):
            if self.faults is not None:
                spec = self.faults.drift_at(rnd)
                if spec is not None:
                    self._apply_drift(spec)
                    if rec.enabled:
                        rec.inc("fault.injections", 1, kind="drift",
                                round=rnd, at=spec.at)
            # 1. arrivals: reveal new environment samples to each sensor
            # (drawn for every node every round so the arrival stream does
            # not depend on the crash schedule; a crashed sensor just
            # samples none)
            draw = self.arrivals.draw(self._arr_rng, p)
            down = self._down_now(rnd)
            draw = np.where(down, 0, draw)
            if rec.enabled and self.faults is not None \
                    and self.faults.crashes:
                rec.gauge("fault.nodes_down", int(down.sum()), round=rnd)
            target = np.minimum(self.est.counts + draw, len(self.pool))
            need = int(target.max()) if p else 0
            if need > self._fed:
                self.est.extend_pool(self.pool[self._fed: need])
                self._fed = need
            self.est.advance(target)

            if self.estimator == "one_step":
                self._step_one_step(rnd, down)
            else:
                self._step_admm(rnd, down)
            self.round += 1

    def _corrupt_vals(self, spec, vals: Dict) -> Dict:
        """Byzantine outbound corruption of one message's estimates. The
        transmitted weight is untouched: a convincing liar claims its
        honest precision."""
        out = {}
        for a, (e, w) in vals.items():
            if spec.kind == "sign_flip":
                e = -e
            elif spec.kind == "scaled_noise":
                e = e + spec.scale * float(self._fault_rng.randn())
            else:                                    # fixed_value, colluding
                e = float(spec.value)
            out[a] = (e, w)
        return out

    def _step_one_step(self, rnd: int, down: np.ndarray) -> None:
        # 2. incremental warm-started re-fit on the configured cadence
        if rnd % self.refit_every == 0:
            self.est.refit()
        fits = self.est.fits
        if fits is None:
            return
        eff = self.est.effective_counts
        replay = self.faults.replay if self.faults is not None else None
        # 3. broadcast fresh shared-parameter estimates over live links
        for (i, j) in self.net.links:
            shared = self._shared[(i, j)]
            if not shared or self.est.versions[i] <= self._last_sent[(i, j)]:
                continue
            if self.est.counts[i] == 0:
                continue            # no data yet -> nothing worth sending
            if down[i] or down[j]:
                continue            # a crashed endpoint kills the link
            if not self.net.link_active(rnd, i, j):
                continue            # retry while the version stays fresh
            vals = {}
            n_i = max(float(eff[i]), 1e-12)
            for a in shared:
                pos = fits[i].beta.index(a)
                if not self._sends_weight:
                    # weights are identically 1 and not transmitted
                    vals[a] = (float(fits[i].theta[pos]), 1.0)
                else:
                    # weight = the estimator's variance V_aa / n_i (n_i the
                    # effective window/discount mass), so owners with more
                    # data count for more (Prop 4.7)
                    vals[a] = (float(fits[i].theta[pos]),
                               float(fits[i].V[pos, pos]) / n_i)
            spec = (self.faults.byzantine_for(i, rnd)
                    if self.faults is not None else None)
            if spec is not None:
                vals = self._corrupt_vals(spec, vals)
                if self.recorder.enabled:
                    self.recorder.inc("fault.injections", 1,
                                      kind="byzantine", node=i,
                                      attack=spec.kind, round=rnd)
            payload = {"vals": vals, "version": int(self.est.versions[i]),
                       "sent_round": rnd}
            n_scal = one_step_message_scalars(len(shared), self.scheme)
            if self.net.send(rnd, i, j, payload, n_scal):
                # a drop is only "paid for": the update is still owed, so
                # the link keeps retrying until a copy gets through
                self._last_sent[(i, j)] = int(self.est.versions[i])
                # replay attack: re-inject the link's PREVIOUS payload as a
                # late, stale duplicate (billed as real traffic)
                prev = self._last_payload.get((i, j))
                if replay is not None and prev is not None \
                        and self._fault_rng.rand() < replay.prob:
                    self.net.send(rnd, i, j, prev, n_scal,
                                  extra_delay=replay.delay)
                    if self.recorder.enabled:
                        self.recorder.inc("fault.injections", 1,
                                          kind="replay", src=i, dst=j,
                                          round=rnd)
                self._last_payload[(i, j)] = payload
        # 4. deliveries update the receiver's view of its peers
        self._deliver_views(rnd)

    def _step_admm(self, rnd: int, down: np.ndarray) -> None:
        # 2. one warm-started proximal primal round over the growing buffers
        est = self.est
        X = est.buffer.tensor
        masks = est.buffer.window_weights(est.counts, est.window,
                                          est.discount)
        self._admm_theta = prox_update_batched(
            self.graph, X, self._admm_bar, self._admm_lam, self._admm_rho,
            thetas0=self._admm_theta,
            include_singleton=self.include_singleton,
            theta_fixed=torch.as_tensor(
                self.theta_fixed.astype(np.float32), device=X.device),
            sample_weight=masks, n_iter=self.newton_iters,
            family=self.family)
        # NaN or runaway primal iterates (degenerate small-n prox solves)
        # would be absorbing through the warm start and the dual update:
        # reset the offending coordinates to their consensus view instead
        self._admm_theta = [
            np.where(np.isfinite(t) & (np.abs(t) <= TRUST_RADIUS), t, b)
            for t, b in zip(self._admm_theta, self._admm_bar)]
        # 3. exchange shared coordinates
        for (i, j) in self.net.links:
            shared = self._shared[(i, j)]
            if not shared or down[i] or down[j] \
                    or not self.net.link_active(rnd, i, j):
                continue
            beta = self._betas[i]
            vals = {a: (float(self._admm_theta[i][beta.index(a)]), 1.0)
                    for a in shared}
            spec = (self.faults.byzantine_for(i, rnd)
                    if self.faults is not None else None)
            if spec is not None:
                vals = self._corrupt_vals(spec, vals)
                if self.recorder.enabled:
                    self.recorder.inc("fault.injections", 1,
                                      kind="byzantine", node=i,
                                      attack=spec.kind, round=rnd)
            payload = {"vals": vals, "version": rnd, "sent_round": rnd}
            self.net.send(rnd, i, j, payload,
                          admm_message_scalars(len(shared)))
        self._deliver_views(rnd)
        # 4. consensus averaging from possibly-stale views + dual ascent
        for i in range(self.graph.p):
            beta = self._betas[i]
            rho = self._admm_rho[i]
            for pos, a in enumerate(beta):
                own = float(self._admm_theta[i][pos])
                num = rho[pos] * own
                den = rho[pos]
                for (node, _) in self._owners[a]:
                    if node == i:
                        continue
                    view = self._view.get((i, node))
                    if view is not None and a in view["vals"]:
                        val = view["vals"][a][0]
                        if _guard(val, 1.0):
                            num += rho[pos] * val
                            den += rho[pos]
                self._admm_bar[i][pos] = num / den
            self._admm_lam[i] = self._admm_lam[i] + rho * (
                np.asarray(self._admm_theta[i]) - self._admm_bar[i])

    def _deliver_views(self, rnd: int) -> None:
        """Apply due messages to receiver views, freshest version wins;
        messages addressed to a crashed receiver are lost (delivered by the
        network, never processed)."""
        down = self._down_now(rnd)
        for msg in self.net.deliver(rnd):
            if down[msg.dst]:
                continue
            key = (msg.dst, msg.src)
            cur = self._view.get(key)
            if cur is None or msg.payload["version"] >= cur["version"]:
                self._view[key] = msg.payload

    # ------------------------------------------------------------- querying
    def current_estimate(self) -> np.ndarray:
        """Combined network estimate right now (home-sensor convention:
        each parameter is reported by its lowest-index owner, which fuses
        its own estimate with the freshest peer estimates it has
        received)."""
        theta = self.theta_fixed.copy()
        if self.estimator == "admm":
            for a, own in self._owners.items():
                home = min(node for node, _ in own)
                pos = self._betas[home].index(a)
                val = float(self._admm_bar[home][pos])
                if _guard(val, 1.0):
                    theta[a] = val
            return theta

        fits = self.est.fits
        if fits is None:
            return theta
        eff = self.est.effective_counts
        anchored = getattr(self.combiner, "anchored", False)
        rec = self.recorder
        guard_rej = robust_rej = 0
        for a, own in self._owners.items():
            home = min(node for node, _ in own)
            raw = []
            if self.est.counts[home] > 0:
                pos = fits[home].beta.index(a)
                if not self._sends_weight:
                    raw.append((float(fits[home].theta[pos]), 1.0, True))
                else:
                    raw.append((float(fits[home].theta[pos]),
                                float(fits[home].V[pos, pos])
                                / max(float(eff[home]), 1e-12), True))
            for (node, _) in own:
                if node == home:
                    continue
                view = self._view.get((home, node))
                if view is not None and a in view["vals"]:
                    e, v = view["vals"][a]
                    raw.append((e, v, False))
            # data-free owners are excluded at the source (a count-0 node
            # neither broadcasts nor contributes its V = 0 fit); the clamp
            # only steadies near-saturated variances
            cands, own_index = [], None
            for (e, v, is_own) in raw:
                if _guard(e, v):
                    if is_own:
                        own_index = len(cands)
                    cands.append((e, max(v, 1e-12)))
                else:
                    guard_rej += 1
            if not cands:
                continue
            # robust (anchored) combiners also learn which candidate is the
            # receiver's own honest fit
            if anchored:
                theta[a] = self.combiner.combine_candidates(
                    cands, own_index=own_index)
                if rec.enabled:
                    mask = self.combiner.filter_mask(
                        cands, own_index=own_index)
                    if mask is not None:
                        robust_rej += len(cands) - int(
                            np.count_nonzero(mask))
            else:
                theta[a] = self.combiner.combine_candidates(cands)
        if rec.enabled:
            if guard_rej:
                rec.inc("combine.guard_rejections", guard_rej,
                        round=self.round)
            if robust_rej:
                rec.inc("combine.robust_rejections", robust_rej,
                        round=self.round)
        return theta

    def mean_staleness(self) -> float:
        """Mean age in rounds of the peer views backing the estimate."""
        ages = [self.round - 1 - v["sent_round"]
                for v in self._view.values()]
        return float(np.mean(ages)) if ages else 0.0

    # ------------------------------------------------------------ durability
    @staticmethod
    def _payload_to_json(payload: Dict) -> Dict:
        return {"vals": {str(a): [float(e), float(w)]
                         for a, (e, w) in payload["vals"].items()},
                "version": int(payload["version"]),
                "sent_round": int(payload["sent_round"])}

    @staticmethod
    def _payload_from_json(d: Dict) -> Dict:
        return {"vals": {int(a): (float(ew[0]), float(ew[1]))
                         for a, ew in d["vals"].items()},
                "version": int(d["version"]),
                "sent_round": int(d["sent_round"])}

    def state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Complete mid-stream state as (arrays, json_meta), under the
        reference's keys: estimator bank, environment pool and truth,
        per-link owed versions and last payloads, received peer views,
        in-flight network queue, bandwidth counters, and every RandomState.
        A fresh simulator constructed with the same configuration +
        :meth:`load_state` continues identically."""
        arrays, meta = self.est.state_dict()
        arrays = dict(arrays)
        arrays["sim/pool"] = self.pool.cpu().numpy().copy()
        if self.theta_star is not None:
            arrays["sim/theta_star"] = self.theta_star.copy()
        if self.estimator == "admm":
            for i in range(self.graph.p):
                arrays[f"sim/admm_theta_{i}"] = np.asarray(
                    self._admm_theta[i])
                arrays[f"sim/admm_lam_{i}"] = np.asarray(self._admm_lam[i])
                arrays[f"sim/admm_bar_{i}"] = np.asarray(self._admm_bar[i])
        meta.update({
            "round": int(self.round),
            "fed": int(self._fed),
            "seed": self.seed,
            "scheme": self.scheme,
            "estimator": self.estimator,
            "last_sent": [[int(i), int(j), int(v)]
                          for (i, j), v in self._last_sent.items()],
            "last_payload": [[int(i), int(j), self._payload_to_json(p)]
                             for (i, j), p in self._last_payload.items()],
            "views": [[int(dst), int(src), self._payload_to_json(p)]
                      for (dst, src), p in self._view.items()],
            "arr_rng": rng_state_to_json(self._arr_rng),
            "fault_rng": rng_state_to_json(self._fault_rng),
            "net_rng": rng_state_to_json(self.net._rng),
            "net_counters": self.net.counters_dict(),
            "net_queue": [[int(m.src), int(m.dst),
                           self._payload_to_json(m.payload),
                           int(m.n_scalars), int(m.created),
                           int(m.deliver_at)] for m in self.net._queue],
        })
        return arrays, meta

    def load_state(self, arrays: Dict[str, np.ndarray],
                   meta: Dict) -> None:
        """Inverse of :meth:`state_dict`, in place, on a simulator
        constructed with the same configuration (graph, pool shape,
        scheme, faults, network config, seed)."""
        if meta["scheme"] != self.scheme \
                or meta["estimator"] != self.estimator:
            raise ValueError(
                f"checkpoint was written by a "
                f"{meta['estimator']}/{meta['scheme']} simulator; this one "
                f"is {self.estimator}/{self.scheme}")
        self.est.load_state(arrays, meta)
        self.pool = self._own_pool(np.asarray(arrays["sim/pool"]))
        if "sim/theta_star" in arrays:
            self.theta_star = np.asarray(arrays["sim/theta_star"]).copy()
        if self.estimator == "admm":
            self._admm_theta = [np.asarray(
                arrays[f"sim/admm_theta_{i}"]).copy()
                for i in range(self.graph.p)]
            self._admm_lam = [np.asarray(arrays[f"sim/admm_lam_{i}"]).copy()
                              for i in range(self.graph.p)]
            self._admm_bar = [np.asarray(arrays[f"sim/admm_bar_{i}"]).copy()
                              for i in range(self.graph.p)]
        self.round = int(meta["round"])
        self._fed = int(meta["fed"])
        self._last_sent = {(int(i), int(j)): int(v)
                           for i, j, v in meta["last_sent"]}
        self._last_payload = {(int(i), int(j)): self._payload_from_json(p)
                              for i, j, p in meta["last_payload"]}
        self._view = {(int(dst), int(src)): self._payload_from_json(p)
                      for dst, src, p in meta["views"]}
        rng_state_from_json(self._arr_rng, meta["arr_rng"])
        rng_state_from_json(self._fault_rng, meta["fault_rng"])
        rng_state_from_json(self.net._rng, meta["net_rng"])
        self.net.set_counters(meta["net_counters"])
        self.net._queue = [
            Message(src=int(s), dst=int(d),
                    payload=self._payload_from_json(p), n_scalars=int(n),
                    created=int(c), deliver_at=int(at))
            for s, d, p, n, c, at in meta["net_queue"]]

    # ------------------------------------------------------------ trajectory
    def run(self, rounds: int, record_every: int = 1,
            record_score: bool = False) -> StreamResult:
        """Step ``rounds`` rounds, recording every ``record_every``-th (and
        the last); ``record_score`` adds the pseudo-score norm of each
        recorded estimate (one score-kernel launch on the card)."""
        # the estimate the network reports as recording starts
        initial = self.current_estimate()
        tel = self.recorder
        mark = tel.mark()
        recs: List[dict] = []
        with tel.span("stream", rounds=rounds):
            for r in range(rounds):
                self.step()
                if (r + 1) % record_every == 0 or r == rounds - 1:
                    theta = self.current_estimate()
                    rec = {
                        "round": self.round,
                        "theta": theta,
                        "seen": float(self.est.counts.mean()),
                        "total": int(self.est.counts.sum()),
                        "scalars": int(self.net.scalars_sent),
                        "stale": self.mean_staleness(),
                    }
                    if self.theta_star is not None:
                        d = (theta - self.theta_star)[self.free]
                        rec["err"] = float(d @ d)
                    if record_score:
                        rec["score"] = self.est.score_norm(theta)
                    recs.append(rec)
                    if tel.enabled:
                        # timeline samples: the recorded columns' values at
                        # their rounds, so a snapshot's or a JSONL replay's
                        # timeline() is exact
                        tel.point("scalars_sent", self.round,
                                  rec["scalars"])
                        tel.point("samples_seen", self.round, rec["seen"])
                        tel.point("staleness", self.round, rec["stale"])
                        if "err" in rec:
                            tel.point("err", self.round, rec["err"])
                        if "score" in rec:
                            tel.point("score_norm", self.round,
                                      rec["score"])
        tel.flush()
        return StreamResult(
            rounds=np.array([r["round"] for r in recs]),
            theta=np.stack([r["theta"] for r in recs]),
            samples_seen=np.array([r["seen"] for r in recs]),
            samples_total=np.array([r["total"] for r in recs]),
            scalars_sent=np.array([r["scalars"] for r in recs]),
            err=(np.array([r["err"] for r in recs])
                 if self.theta_star is not None else None),
            score_norm=(np.array([r["score"] for r in recs])
                        if record_score else None),
            staleness=np.array([r["stale"] for r in recs]),
            initial=initial,
            telemetry=tel.snapshot(mark) if tel.enabled else None)
