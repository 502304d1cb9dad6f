#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  1. build the CUDA kernels from src/repro_torch/csrc/ (one nvcc each, in
     parallel) and print the build seconds;
  2. print the card's name and power limit (nvidia-smi);
  3. hold every kernel against its plain PyTorch version on the card: all
     three epilogue kinds, weighted and unweighted, shapes that do not divide
     the tiles, and the exact bucket and score shapes of phases 4 and 5; time
     kernel, plain version and a library yardstick with CUDA events;
  4. paper scale (Fig. 4 of the paper at p = 100, n = 4000): Ising on a
     Euclidean and a scale-free graph, Potts (q = 3) on the Euclidean graph;
     kernel fits against plain fits, and the diagonal combiner's error to the
     truth shrinking from n = 1000 to n = 4000;
  5. deployment scale: a 64 x 64 sensor grid (p = 4096) at n = 16384, cold
     and warm fit wall seconds, and the device's busy share of a profiled
     warm fit;
  6. launch counts: the Newton kernel ran at least once per bucket per Newton
     iteration, the score kernel once per fit, and no plain version saw a
     CUDA tensor during the kernel-path fits.

Samples are drawn here, seeded, by a chromatic Gibbs sweep written with
neighbour lists in torch on the card; true parameters come from a seeded
torch.Generator. Prints one {"kernels": [...]} line and, last, one
{"ok": true, "device": {...}} line; exits non-zero on any failure, and
without a result when there is no CUDA device or no repro_torch beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: relative (normwise) error gates: float32 sums taken in another order
GATE_STATS = 1e-4     # g, K, S: long reductions over samples
GATE_ELEM = 1e-5      # eta, r: short sums over a node's neighbours
#: kernel fit against plain fit, on theta
GATE_THETA = 1e-4

#: data-sheet rates by the name nvidia-smi reports (bytes/s, FP32 FLOP/s
#: outside the tensor cores)
CARD_RATES = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H100", 3.35e12, 67e12))

PAPER_COMBINERS = ("uniform", "diagonal", "optimal", "max")
FIELD_COMBINERS = ("diagonal", "max")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    return CARD_RATES[-1][1:]


class Timer:
    """CUDA-event timing of a callable, mean ms over ``reps`` launches."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def turns(self, plain, kernel, library, reps: int):
        """(kernel_ms, plain_ms, library_ms) timed plain, kernel, kernel,
        plain (then the library call), so drift hits both alike."""
        p1 = self(plain, reps)
        k1 = self(kernel, reps)
        k2 = self(kernel, reps)
        p2 = self(plain, reps)
        lib = self(library, reps) if library is not None else None
        return (k1 + k2) / 2, (p1 + p2) / 2, lib


# ---------------------------------------------------------------- sampling
def gibbs_sample(torch, graph, family: str, theta, n: int, sweeps: int,
                 gen, device, q: int = 3):
    """n samples from n independent chains of a chromatic Gibbs sampler.

    Neighbour lists on the card: per node, its neighbours' columns (padded
    with a dummy all-zero column) and the matching edge parameters; a
    color class updates in one gather, never a dense p x p product.
    """
    p, C = graph.p, (1 if family == "ising" else q - 1)
    deg = [len(graph.incident_edges(i)) for i in range(p)]
    dmax = max(1, max(deg))
    nbr = torch.full((p, dmax), p, dtype=torch.int64)
    w = torch.zeros((p, dmax, C), dtype=torch.float32)
    th = theta.to(torch.float32).cpu()
    for i in range(p):
        for s, k in enumerate(graph.incident_edges(i)):
            a, b = graph.edges[k]
            nbr[i, s] = b if a == i else a
            w[i, s] = th[p * C + k * C: p * C + (k + 1) * C]
    h = th[: p * C].reshape(p, C).to(device)
    nbr, w = nbr.to(device), w.to(device)
    colors = graph.greedy_coloring()
    classes = [torch.as_tensor((colors == c).nonzero()[0], device=device)
               for c in range(int(colors.max()) + 1)]
    X = torch.zeros((n, p + 1), dtype=torch.float32, device=device)
    if family == "ising":
        X[:, :p] = torch.where(torch.rand((n, p), generator=gen,
                                          device=device) < 0.5, 1.0, -1.0)
    else:
        X[:, :p] = torch.randint(0, q, (n, p), generator=gen,
                                 device=device).float()
    chans = torch.arange(1, q, device=device, dtype=torch.float32)
    for _ in range(sweeps):
        for nodes in classes:
            vals = X[:, nbr[nodes]]                          # (n, kc, dmax)
            u = torch.rand((n, len(nodes)), generator=gen, device=device)
            if family == "ising":
                eta = h[nodes, 0] + (vals * w[nodes, :, 0]).sum(-1)
                X[:, nodes] = torch.where(u < torch.sigmoid(2.0 * eta),
                                          1.0, -1.0)
            else:
                feat = (vals[..., None] == chans).float()    # (n,kc,dmax,C)
                eta = h[nodes] + (feat * w[nodes]).sum(-2)   # (n, kc, C)
                logits = torch.cat([torch.zeros_like(eta[..., :1]), eta], -1)
                cdf = torch.softmax(logits, -1).cumsum(-1)
                X[:, nodes] = (cdf[..., :-1] < u[..., None]).sum(-1).float()
    return X[:, :p].contiguous()


def field_profile(torch, sess, X):
    """The device's busy share of one warm fit and its top device kernels,
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.fit(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"  profiled warm fit: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%, under the profiler)")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        if dev_us(e) > 0:
            print(f"    device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:90]}")


# ------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    import repro_torch.api as A
    from repro_torch.core import (euclidean_graph, grid_graph,
                                  scale_free_graph)
    from repro_torch.core.batched import _bucket_design
    from repro_torch.kernels.build import LIBRARIES
    from repro_torch.kernels.cl import kernel as kmod
    from repro_torch.kernels.cl import newton as nmod
    from repro_torch.kernels.cl import ops as omod
    from repro_torch.kernels.cl.family import family_kernel_inputs

    dev = torch.device("cuda")
    timer = Timer(torch)
    failures = []

    def gate(ok: bool, what: str):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    # ---- phase 1: build -------------------------------------------------
    build_s = LIBRARIES.build_all()
    print(f"phase 1: built {LIBRARIES.builds} kernel libraries in "
          f"{build_s:.2f} s", flush=True)
    for lib, text in LIBRARIES.ptxas.items():
        for line in text.splitlines():
            if "Used" in line:
                print(f"  ptxas {lib}: {line.split(':', 1)[1].strip()}")

    # ---- phase 2: card identity -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind_name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(kind_name)
    print(f"phase 2: {kind_name}; bound rates {bw:.3g} B/s, "
          f"{flops:.3g} FP32 FLOP/s (data sheet)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20120626)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(4)

    def truth(graph, family, scale_edge, scale_node, q=3):
        C = 1 if family == "ising" else q - 1
        node = scale_node * torch.randn(graph.p * C, generator=cpu_gen,
                                        dtype=torch.float64)
        edge = scale_edge * torch.randn(graph.m * C, generator=cpu_gen,
                                        dtype=torch.float64)
        return torch.cat([node, edge])

    # data of phases 4 and 5, drawn first so phase 3 can use their shapes
    t0 = time.perf_counter()
    g_eu = euclidean_graph(100, radius=0.15, seed=0)
    g_sf = scale_free_graph(100, m=1, seed=0)
    g_field = grid_graph(64, 64)
    paper = []
    for name, g, fam, combs in (
            ("euclidean_ising", g_eu, "ising", PAPER_COMBINERS),
            ("scalefree_ising", g_sf, "ising", PAPER_COMBINERS),
            ("euclidean_potts3", g_eu, "potts", ("diagonal",))):
        th = (truth(g, fam, 0.5, 0.5) if fam == "ising"
              else truth(g, fam, 0.4, 0.3))
        X = gibbs_sample(torch, g, fam, th, 4000, 150, gen, dev)
        paper.append((name, g, fam, combs, th, X))
    th_field = truth(g_field, "ising", 0.5, 0.5)
    X_field = gibbs_sample(torch, g_field, "ising", th_field, 2 * 16384, 100,
                           gen, dev)
    torch.cuda.synchronize()
    print(f"sampling: {time.perf_counter() - t0:.2f} s (chromatic Gibbs on "
          f"the card)", flush=True)

    # ---- phase 3: kernels against their plain versions ------------------
    print("phase 3: kernels against their plain versions on the card")
    errs = {"newton": 0.0, "score_c1": 0.0, "score_cn": 0.0}

    def check_newton(tag, kind, Zb, base, xi, W, sw):
        g1, K1 = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
        g0, K0 = nmod.bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
        torch.cuda.synchronize()
        eg, eK = rel_err(g1, g0), rel_err(K1, K0)
        errs["newton"] = max(errs["newton"], abs_err(g1, g0),
                             abs_err(K1, K0))
        gate(eg <= GATE_STATS and eK <= GATE_STATS,
             f"newton {tag}: rel g {eg:.2e} K {eK:.2e}")

    def check_score(tag, kind, F, th, mask, bias):
        e1, r1, S1 = kmod.cl_score_channels(F, th, mask, bias, kind=kind)
        e0, r0, S0 = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
        torch.cuda.synchronize()
        ee, er, eS = rel_err(e1, e0), rel_err(r1, r0), rel_err(S1, S0)
        key = "score_c1" if F.shape[0] == 1 else "score_cn"
        errs[key] = max(errs[key], abs_err(e1, e0), abs_err(r1, r0),
                        abs_err(S1, S0))
        gate(ee <= GATE_ELEM and er <= GATE_ELEM and eS <= GATE_STATS,
             f"score {tag}: rel eta {ee:.2e} r {er:.2e} S {eS:.2e}")

    # synthetic: all kinds, weighted and not, ragged n and p
    for kind, C in (("ising", 1), ("gaussian", 1), ("potts", 2)):
        for d in (2, 5, 17, 65):
            for weighted in (False, True):
                k, n = 7, 1001
                if kind == "potts":
                    xi = torch.randint(0, 3, (k, n), generator=gen,
                                       device=dev).float()
                    Zb = (torch.randint(0, 3, (k, C, d, n), generator=gen,
                                        device=dev) == 1).float()
                elif kind == "ising":
                    xi = torch.where(torch.rand((k, n), generator=gen,
                                                device=dev) < .5, 1., -1.)
                    Zb = torch.where(torch.rand((k, C, d, n), generator=gen,
                                                device=dev) < .5, 1., -1.)
                else:
                    xi = torch.randn((k, n), generator=gen, device=dev)
                    Zb = torch.randn((k, C, d, n), generator=gen, device=dev)
                base = 0.1 * torch.randn((k, C, n), generator=gen, device=dev)
                W = 0.1 * torch.randn((k, d * C), generator=gen, device=dev)
                sw = ((torch.rand((k, n), generator=gen, device=dev) < .7)
                      .float() if weighted else None)
                check_newton(f"{kind} k={k} d={d} n={n} weighted={weighted}",
                             kind, Zb, base, xi, W, sw)
        for n, p in ((1001, 37), (333, 130)):
            if kind == "potts":
                x = torch.randint(0, 3, (n, p), generator=gen,
                                  device=dev).float()
                F = torch.stack([(x == c).float() for c in range(1, C + 1)])
            elif kind == "ising":
                F = torch.where(torch.rand((1, n, p), generator=gen,
                                           device=dev) < .5, 1., -1.)
            else:
                F = torch.randn((1, n, p), generator=gen, device=dev)
            th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
            th = (th + th.transpose(1, 2)).contiguous()
            mask = (torch.rand((p, p), generator=gen, device=dev) < .1).float()
            mask = ((mask + mask.T) > 0).float()
            bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
            check_score(f"{kind} n={n} p={p}", kind, F, th, mask, bias)

    # the exact shapes of phases 4 and 5
    timing = []

    def bucket_inputs(g, fam, X, weighted):
        sess = A.Plan(graph=g, family=fam).session()
        out = []
        for b in sess.buckets:
            nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
            nbrs = torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev)
            mask = torch.as_tensor(b.mask, device=dev)
            Zb, xi, base, _ = _bucket_design(
                sess.family, X, nodes, nbrs, mask, None, True)
            k, C, d, n = Zb.shape
            W = 0.05 * torch.randn((k, d * C), generator=gen, device=dev)
            sw = ((torch.rand((k, n), generator=gen, device=dev) < .8)
                  .float() if weighted else None)
            out.append((b.deg_pad, (Zb, base, xi, W, sw)))
        return sess, out

    def newton_cost(Zb, base, xi, W, sw):
        k, C, d, n = Zb.shape
        dC = d * C
        nbytes = sum(t.numel() * t.element_size()
                     for t in (Zb, base, xi, W) + ((sw,) if sw is not None
                                                   else ()))
        nbytes += 4 * (k * dC + k * dC * dC)
        nflop = k * n * (4 * dC + dC * (dC + 1))
        return nbytes, nflop

    def score_cost(C, n, p, nnz):
        """Bytes and FP32 operations of the kernel's contract: the masked
        product counted by the nonzeros of A (its only needed work), the
        full C x C Gram S = r^T F / n that the kernel writes."""
        nbytes = 4 * (C * n * p + C * p * p + p * p + C * p + 2 * C * n * p
                      + C * C * p * p)
        nflop = 2 * C * n * nnz + 2 * C * C * n * p * p
        return nbytes, nflop

    def edge_score_cost(C, n, p, nnz):
        """The fit path's own need: fused_pseudo_score reads only the
        channel-diagonal edge entries of S, so eta over the nonzeros of A
        and one length-n dot per directed edge and channel suffice."""
        nbytes = 4 * (C * n * p + C * nnz + C * p + C * nnz)
        nflop = 2 * C * n * nnz + 2 * C * n * nnz
        return nbytes, nflop

    def bound(nbytes, nflop):
        tb, tf = nbytes / bw * 1e3, nflop / flops * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def time_newton(tag, kind, args, reps):
        Zb, base, xi, W, sw = args
        k, C, d, n = Zb.shape
        Z1 = Zb.reshape(k, C * d, n)
        Z1t = Z1.transpose(1, 2).contiguous()
        kms, pms, lms = timer.turns(
            lambda: nmod.bucket_newton_stats_ref(kind, *args),
            lambda: nmod.bucket_newton_stats(kind, *args),
            lambda: torch.bmm(Z1, Z1t), reps)
        bms, by = bound(*newton_cost(*args))
        row = dict(op="newton", tag=tag, ms=kms, plain_ms=pms,
                   library_ms=lms, bound_ms=bms, bound_by=by)
        timing.append(row)
        print(f"  time newton {tag}: kernel {kms:.4f} ms, plain {pms:.4f} "
              f"ms, bmm {lms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        return row

    def time_score(tag, kind, F, th, mask, bias, reps):
        C, n, p = F.shape
        B = (th * mask[None]).contiguous()
        _, r, _ = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
        rT = r.transpose(1, 2).contiguous()

        def library():
            torch.matmul(F, B)
            torch.matmul(rT, F)
        kms, pms, lms = timer.turns(
            lambda: kmod.cl_score_channels_ref(F, th, mask, bias, kind),
            lambda: kmod.cl_score_channels(F, th, mask, bias, kind=kind),
            library, reps)
        nnz = int(mask.count_nonzero())
        bms, by = bound(*score_cost(C, n, p, nnz))
        ems, eby = bound(*edge_score_cost(C, n, p, nnz))
        row = dict(op="score", tag=tag, ms=kms, plain_ms=pms,
                   library_ms=lms, bound_ms=bms, bound_by=by)
        timing.append(row)
        print(f"  time score {tag}: kernel {kms:.4f} ms, plain {pms:.4f} ms,"
              f" 2x matmul {lms:.4f} ms, bound {bms:.4f} ms ({by}); the fit "
              f"path's edge-only bound {ems:.4f} ms ({eby})", flush=True)
        return row

    main_rows = {}
    for name, g, fam, combs, th, X in paper:
        for weighted in (False, True):
            _, buckets = bucket_inputs(g, fam, X, weighted)
            for deg_pad, args in buckets:
                k, C, d, n = args[0].shape
                tag = f"{name} bucket d={d} k={k} n={n} weighted={weighted}"
                check_newton(tag, fam, *args)
                if not weighted:
                    time_newton(tag, fam, args, 50)
        F, thc, mask, bias = family_kernel_inputs(
            A.Plan(graph=g, family=fam).family_instance, g,
            th.to(dev, torch.float32), X)
        check_score(f"{name} n={X.shape[0]} p={g.p}", fam, F, thc, mask,
                    bias)
        row = time_score(f"{name} n={X.shape[0]} p={g.p} C={F.shape[0]}",
                         fam, F, thc, mask, bias, 50)
        if fam == "potts":
            main_rows["score_cn"] = row
    Xf = X_field[:16384]
    _, buckets = bucket_inputs(g_field, "ising", Xf, False)
    for deg_pad, args in buckets:
        k, C, d, n = args[0].shape
        tag = f"field_ising bucket d={d} k={k} n={n}"
        check_newton(tag, "ising", *args)
        main_rows["newton"] = time_newton(tag, "ising", args, 10)
    del buckets
    F, thc, mask, bias = family_kernel_inputs(
        A.Plan(graph=g_field).family_instance, g_field,
        th_field.to(dev, torch.float32), Xf)
    check_score(f"field_ising n={Xf.shape[0]} p={g_field.p}", "ising", F,
                thc, mask, bias)
    main_rows["score_c1"] = time_score(
        f"field_ising n={Xf.shape[0]} p={g_field.p} C=1", "ising", F, thc,
        mask, bias, 3)
    del F, thc, mask, bias
    torch.cuda.empty_cache()

    # ---- plain versions must see no CUDA tensor on the kernel path -------
    plain_cuda_calls = {"n": 0}

    def counting(fn):
        def wrapped(*args, **kwargs):
            if any(getattr(a, "is_cuda", False) for a in args):
                plain_cuda_calls["n"] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, name in ((omod, "bucket_newton_stats_ref"),
                      (omod, "cl_score_channels_ref"),
                      (nmod, "bucket_newton_stats_ref"),
                      (kmod, "cl_score_channels_ref")):
        setattr(mod, name, counting(getattr(mod, name)))

    launches = {"newton": 0, "score_c1": 0, "score_cn": 0}

    def main_path(sess, X, score_key):
        """One fit on the kernel path with every count set to 0 just
        before it and read just after."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        t0 = time.perf_counter()
        res = sess.fit(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl = nmod.bucket_newton_stats.launches
        sl = kmod.cl_score_channels.launches
        pc = plain_cuda_calls["n"]
        launches["newton"] += nl
        launches[score_key] += sl
        iters = {}
        sess.fit_local(X, iters=iters)
        gate(nl >= sum(iters.values()) and sl == 1 and pc == 0,
             f"launches: newton {nl} for Newton iterations {iters}, score "
             f"{sl}, plain calls on CUDA tensors {pc}")
        return res, wall

    def finite_result(res, g, fam):
        C = 1 if fam == "ising" else 2
        ok = all(np.all(np.isfinite(v)) and v.shape == ((g.p + g.m) * C,)
                 for v in res.combined.values())
        return ok and np.isfinite(res.score_norm)

    # ---- phase 4: paper scale --------------------------------------------
    print("phase 4: paper scale (Fig. 4, p = 100)")
    for name, g, fam, combs, th, X in paper:
        sess = A.Plan(graph=g, family=fam, combiners=combs).session()
        score_key = "score_c1" if fam == "ising" else "score_cn"
        res, wall = main_path(sess, X, score_key)
        plain_cuda_calls["n"] = 0
        res_plain = sess.fit(X, use_kernel=False)
        gate(plain_cuda_calls["n"] > 0,
             f"{name}: use_kernel=False reached the plain versions "
             f"({plain_cuda_calls['n']} calls)")
        dth = max(float(np.max(np.abs(res.combined[c]
                                      - res_plain.combined[c])))
                  for c in combs)
        dloc = max(float(np.max(np.abs(a.theta - b.theta)))
                   for a, b in zip(res.fits, res_plain.fits))
        gate(dth <= GATE_THETA and finite_result(res, g, fam),
             f"{name}: kernel vs plain fit, combined theta max diff "
             f"{dth:.2e} (local {dloc:.2e}); fit wall {wall:.3f} s, "
             f"score_norm {res.score_norm:.4e}")
        res_small, _ = main_path(sess, X[:1000], score_key)
        truth_np = th.numpy()
        m1 = res_small.combined["diagonal"] - truth_np
        m4 = res.combined["diagonal"] - truth_np
        mse1, mse4 = float(m1 @ m1), float(m4 @ m4)
        gate(mse4 < mse1, f"{name}: diagonal MSE to truth n=1000 "
             f"{mse1:.4f} > n=4000 {mse4:.4f}")
        for c in combs:
            d = res.combined[c] - truth_np
            print(f"  {name} n=4000 {c}: MSE {float(d @ d):.4f}")

    # ---- phase 5: deployment scale ----------------------------------------
    print("phase 5: deployment scale (64 x 64 grid, n = 16384)")
    sess = A.Plan(graph=g_field, family="ising",
                  combiners=FIELD_COMBINERS).session()
    torch.cuda.reset_peak_memory_stats()
    res_cold, cold = main_path(sess, X_field[:16384], "score_c1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    res_warm, warm = main_path(sess, X_field[16384:], "score_c1")
    print(f"  field fit wall: cold {cold:.3f} s, warm {warm:.3f} s "
          f"(warm new_compiles {res_warm.new_compiles}); peak device memory "
          f"of the cold fit {peak:.2f} GiB")
    res_plain = sess.fit(X_field[16384:], use_kernel=False)
    dth = max(float(np.max(np.abs(res_warm.combined[c]
                                  - res_plain.combined[c])))
              for c in FIELD_COMBINERS)
    gate(dth <= GATE_THETA and finite_result(res_cold, g_field, "ising")
         and finite_result(res_warm, g_field, "ising")
         and res_warm.new_compiles == 0,
         f"field: kernel vs plain combined theta max diff {dth:.2e}")
    for c in FIELD_COMBINERS:
        d = res_warm.combined[c] - th_field.numpy()
        print(f"  field n=16384 {c}: MSE {float(d @ d):.4f} over "
              f"{d.size} parameters")

    field_profile(torch, sess, X_field[16384:])

    # ---- phase 6: launch counts ------------------------------------------
    gate(all(v > 0 for v in launches.values()),
         f"phase 6: main-path launches {launches}")

    kernels = [
        dict(name="bucket_newton_stats", route="cuda",
             source="src/repro_torch/csrc/newton.cu",
             replaces="src/repro/kernels/cl/newton.py:191",
             launches=launches["newton"], max_abs_err=errs["newton"],
             **{k: main_rows["newton"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="cl_score_channels[C=1]", route="cuda",
             source="src/repro_torch/csrc/score.cu",
             replaces="src/repro/kernels/cl/kernel.py:268",
             launches=launches["score_c1"], max_abs_err=errs["score_c1"],
             **{k: main_rows["score_c1"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="cl_score_channels[C>1]", route="cuda",
             source="src/repro_torch/csrc/score.cu",
             replaces="src/repro/kernels/cl/kernel.py:296",
             launches=launches["score_cn"], max_abs_err=errs["score_cn"],
             **{k: main_rows["score_cn"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    if failures:
        print(f"chip_smoke: {len(failures)} gate(s) failed:",
              file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
