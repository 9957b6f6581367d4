"""Chaos or a bias: kernel K3's warm launches on the flight and mission
chains against the plain twin and its perturbed copies, on one NVIDIA GPU.

    python3 k3_chains.py --other DIR [--ticks 300] [--out FILE]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive`), loaded as `kernel_ab.py` loads it:
its `ops/box_qp_ipm.py` under another module name, building its own
`csrc/box_qp_ipm.cu` (both builds start together).

Two chains run eagerly on the card through this checkout's kernel, and
every call of the kernel wrapper is recorded (`chip_smoke.record_launches`):

  - "flight": the flight node's "fastest" chain (the flight preset, K3 in
    the fuse_lin mode, N=30, 3 iterations), TICKS ticks of
    `io/flight.py::FlightNode.tick` with the warm start on;
  - "mission": the 60 s mission's controller (K3 in the plain mode, N=10,
    6 iterations) flying its vehicle in lockstep (`io/mission.py`'s
    SitlLiteVehicle, `io/endurance.py`'s wind and target; each command
    lands at once), TICKS ticks.

Each warm launch of a chain (a valid warm start, not skipped) then runs
again at its own budget through this checkout's kernel and the other
checkout's (one launch each, as on the chain), the plain twin (on the
card, all the chain's launches as one batch), and the twin from the warm
slacks and duals moved by +1e-6, -1e-6 and a random sign times 1e-6
relative. Per source: kkt_eq at the budget; whether it is within the
twin's bound (`chip_smoke.chain_parity`'s rule: |kkt_eq - twin's| less
0.2 of the twin's at most 1e-3), and the QP objective's gap to the
twin's relative to max(|objective|, 1) (within 1.2e-2, chain_parity's
bound, counted). The distributions are compared:
the kernels' within-counts against the moved twins' (Fisher's exact
test against the moved twins pooled), and the kernels' kkt_eq against
each moved twin's (Mann-Whitney U). A bias shows as a kernel whose
counts or kkt_eq sit outside the moved twins' spread; chaos as a kernel
inside it.

Prints one JSON object per line and the card's name and power limit;
with --out also writes them to FILE.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as S
from kernel_ab import load_wrapper

TICKS = 300
KKT_TOL = S.CHAIN_TOL["kkt_eq"]
MOVES = ("+1e-6", "-1e-6", "rand1e-6")
LINES: list = []


def emit(kind: str, **kv):
    line = json.dumps({"kind": kind, **kv})
    LINES.append(line)
    print(line, flush=True)


def flight_chain(dev, n: int):
    from mpc_blaster_tpu_torch.io.flight import FlightNode
    node = FlightNode(preset=S.flight_preset_on("fastest"), warm_start=True,
                      device=dev)
    for _ in range(n):
        node.tick()


def mission_chain(dev, n: int):
    from mpc_blaster_tpu_torch.io.endurance import TARGET, WIND
    from mpc_blaster_tpu_torch.io.mission import SitlLiteVehicle
    ctrl = S.mission_controller(dev, "pallas")
    x_like = np.zeros(17, np.float32)
    x_like[2] = 3.0
    ctrl.warmup(x_like)
    veh = SitlLiteVehicle([0.0, 0.0, 3.0], WIND, dt=0.01, mass=9.0,
                          t_blast=2.2 * 9.81)
    errs = []
    for _ in range(n):
        q, thrust, _ = ctrl.tick(veh.p.copy(), veh.eul.copy(), veh.v.copy())
        veh.command(q, thrust)
        for _ in range(10):
            veh.step()
        errs.append(float(np.linalg.norm(veh.p - TARGET)))
    return {"trips": int(ctrl.wd.trips), "err_final_m": errs[-1],
            "err_max_m": max(errs)}


CHAINS = {"flight": ("fused_rti_solve", flight_chain),
          "mission": ("box_qp_solve", mission_chain)}


def warm_launches(launches: list) -> list:
    """The recorded calls with a valid warm start that were not skipped,
    without the skip flag."""
    out = []
    for a, kw in launches:
        w, s = kw.get("warm"), kw.get("skip")
        if w is not None and bool(w.valid.all()) and not (
                s is not None and bool(s.any())):
            out.append((a, {k: v for k, v in kw.items() if k != "skip"}))
    return out


def moved(w, how: str, gen: torch.Generator):
    """The warm start with its slacks and duals moved by 1e-6 relative."""
    def f(t):
        if how == "rand1e-6":
            sign = torch.randint(0, 2, t.shape, generator=gen,
                                 device="cpu").to(t.device) * 2 - 1
            return t * (1 + 1e-6 * sign)
        return t * (1 + float(how))
    return w._replace(**{k: f(getattr(w, k)) for k in S.SLACK_DUALS})


def chain_sources(wrapper: str, warm: list, mods: dict) -> tuple:
    """Each source's solutions of the chain's warm launches at their
    budget (the kernels one launch at a time, the twins as one batch), and
    the QP of each launch (for the objective)."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    twin = getattr(K, wrapper + "_plain")
    A = S.stack_launches([a for a, _ in warm])
    W = S.stack_launches([kw["warm"] for _, kw in warm])
    kw0 = {k: v for k, v in warm[0][1].items() if k != "warm"}
    out = {}
    for who, M in mods.items():
        t0 = time.perf_counter()
        out[who] = S.stack_launches([getattr(M, wrapper)(*a, **kw)
                                     for a, kw in warm])
        torch.cuda.synchronize()
        emit("replayed", source=who, launches=len(warm),
             s=time.perf_counter() - t0)
    out["twin"] = twin(*A, **dict(kw0, warm=W))
    gen = torch.Generator().manual_seed(0)
    for how in MOVES:
        out["twin" + how] = twin(*A, **dict(kw0, warm=moved(W, how, gen)))
    if wrapper == "box_qp_solve":
        qp = A[0]
    else:
        _, lin = twin(*A, **dict(kw0, warm=W, iters=1, return_lin=True))
        qp = K._fused_qp(K._fused_prep(A[0], A[1], A[3], *A[4:14],
                                       kw0.get("R_grad")), *lin)
    torch.cuda.synchronize()
    return out, qp, kw0["iters"]


def compare(name: str, sols: dict, qp, iters: int) -> dict:
    from scipy import stats
    from torch.func import vmap
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    t = sols["twin"]
    ot = vmap(qp_objective)(qp, t.dx, t.du)
    row = {"chain": name, "launches": int(t.kkt_eq.shape[0]),
           "iters": iters, "sources": {}}
    eq = {}
    for who, x in sols.items():
        e = x.kkt_eq.double().cpu().numpy()
        eq[who] = e
        gap = ((x.kkt_eq - t.kkt_eq).abs() - 0.2 * t.kkt_eq.abs())
        ox = vmap(qp_objective)(qp, x.dx, x.du)
        og = (ox - ot).abs() / ot.abs().clamp(min=1.0)
        row["sources"][who] = {
            "kkt_eq_within": int((gap <= KKT_TOL).sum()),
            "kkt_eq_quantiles": np.quantile(e, [0.1, 0.5, 0.9, 1.0]).tolist(),
            "kkt_eq_mean": float(e.mean()),
            "objective_within": int((og <= S.CHAIN_TOL["objective"]).sum()),
            "objective_gap_median": float(og.median()),
            "objective_gap_max": float(og.max()),
            "finite": bool(torch.isfinite(x.du).all()
                           and torch.isfinite(x.kkt_eq).all())}
    n = row["launches"]
    moved_within = [row["sources"]["twin" + m]["kkt_eq_within"]
                    for m in MOVES]
    pooled = np.concatenate([eq["twin" + m] for m in MOVES])
    for who in ("this", "other"):
        k = row["sources"][who]["kkt_eq_within"]
        _, p = stats.fisher_exact([[k, n - k], [sum(moved_within),
                                                 len(MOVES) * n
                                                 - sum(moved_within)]])
        mw = {m: float(stats.mannwhitneyu(eq[who], eq["twin" + m]).pvalue)
              for m in MOVES}
        mw["pooled"] = float(stats.mannwhitneyu(eq[who], pooled).pvalue)
        row[who] = {"within": k, "moved_within": moved_within,
                    "fisher_p_vs_moved": float(p),
                    "mannwhitney_p_vs_moved": mw,
                    "inside_moved_range": min(moved_within) <= k
                    <= max(moved_within)}
    row["kernels_mannwhitney_p"] = float(
        stats.mannwhitneyu(eq["this"], eq["other"]).pvalue)
    # a bias: the kernel's counts outside the moved twins' spread and told
    # apart from them (Fisher p < 0.01) or its kkt_eq shifted against the
    # pooled moved twins (Mann-Whitney p < 0.01)
    row["verdict"] = {
        who: "bias" if (not row[who]["inside_moved_range"]
                        and row[who]["fisher_p_vs_moved"] < 0.01)
        or row[who]["mannwhitney_p_vs_moved"]["pooled"] < 0.01 else "chaos"
        for who in ("this", "other")}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_chains: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    smi = S.card_line()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0))
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    S.KERNEL_WRAPPERS.update({w: getattr(K, w) for w in S.WRAPPERS})
    mods = {"this": K,
            "other": load_wrapper(a.other.resolve(), "other_box_qp_ipm")}
    with ThreadPoolExecutor(2) as pool:
        built = [f.result() for f in [pool.submit(m.build_library)
                                      for m in mods.values()]]
    for who, (_, secs, _) in zip(mods, built):
        emit("build", which=who, nvcc_s=secs)
    for m in mods.values():
        m._library()
    for name, (wrapper, chain) in CHAINS.items():
        t0 = time.perf_counter()
        info = {}
        launches = S.record_launches(wrapper, lambda: info.update(
            chain(dev, a.ticks) or {}))
        warm = warm_launches(launches)
        emit("chain", chain=name, ticks=a.ticks, calls=len(launches),
             warm_launches=len(warm), s=time.perf_counter() - t0, **info)
        sols, qp, iters = chain_sources(wrapper, warm, mods)
        emit("compare", **compare(name, sols, qp, iters))
    print(smi, flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
