"""Coarse-grained baselines the paper compares against (§4.4).

Both baselines parameterize from the SAME 1-worker profile as our method,
but reduce it to phase durations (no op-level dependencies, no overlap):

* **Lin et al.** (MASCOTS'18 [10]): phases from tcpdump-style inspection —
  downlink duration T_d, computation T_comp (gap between downlink end and
  uplink start), uplink T_u, PS update T_ps.  Workers cycle through the
  phases with NO comm/compute overlap; the PS up/down channels are shared
  processor-sharing stations.  We solve the closed queueing network with
  exact MVA (PS stations: downlink, uplink; delay stations: worker compute,
  PS update).  As the paper observes, this saturates too early when overlap
  is large.

* **Cynthia** (ICPP'19 [24]): throughput = W*K / (T_P * max(1, W*U_1) + 2*T_C)
  with T_P batch processing time, T_C one-way transmission time and U_1 the
  single-worker network utilization.  ``cynthia_half`` is the paper's §4.4
  modification with T_C halved (separate up/down channels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .overhead import RecordedStep


@dataclass(frozen=True)
class CoarsePhases:
    """Phase durations extracted from a 1-worker profile (seconds)."""

    t_down: float
    t_comp: float
    t_up: float
    t_ps: float

    @property
    def step_time(self) -> float:
        return self.t_down + self.t_comp + self.t_up + self.t_ps


def extract_phases(profile: Sequence[RecordedStep]) -> CoarsePhases:
    """The coarse reduction used by prior work: downlink phase = first
    downlink start .. last downlink end; computation = gap until first
    uplink starts; uplink = first uplink start .. last uplink end; ps =
    whatever remains until the step completes."""
    td, tc, tu, tp = [], [], [], []
    for step in profile:
        d_start = min(o.start for o in step.ops if o.res.startswith("downlink"))
        d_end = max(o.end for o in step.ops if o.res.startswith("downlink"))
        u_start = min(o.start for o in step.ops if o.res.startswith("uplink"))
        u_end = max(o.end for o in step.ops if o.res.startswith("uplink"))
        s_end = max(o.end for o in step.ops)
        td.append(d_end - d_start)
        tc.append(max(u_start - d_end, 0.0))
        tu.append(u_end - u_start)
        tp.append(max(s_end - u_end, 0.0))
    n = len(td)
    return CoarsePhases(sum(td) / n, sum(tc) / n, sum(tu) / n, sum(tp) / n)


def lin_throughput(phases: CoarsePhases, num_workers: int,
                   batch_size: int) -> float:
    """Exact MVA for the closed network: PS stations {downlink, uplink},
    delay stations {compute, ps update}; one circulating customer per
    worker; no overlap between phases."""
    d_down, d_up = phases.t_down, phases.t_up
    d_delay = phases.t_comp + phases.t_ps
    q_down = 0.0
    q_up = 0.0
    x = 0.0
    for n in range(1, num_workers + 1):
        r_down = d_down * (1.0 + q_down)
        r_up = d_up * (1.0 + q_up)
        r = r_down + r_up + d_delay
        x = n / r
        q_down = x * r_down
        q_up = x * r_up
    return x * batch_size


def cynthia_throughput(phases: CoarsePhases, num_workers: int,
                       batch_size: int, halve_tc: bool = False) -> float:
    """Cynthia's analytical model, parameterized from the same profile.

    T_C is the one-way transmission time; U_1 the 1-worker network
    utilization.  ``halve_tc`` applies the paper's §4.4 modification.
    """
    t_c = 0.5 * (phases.t_down + phases.t_up)
    if halve_tc:
        t_c = 0.5 * t_c
    t_p = phases.t_comp + phases.t_ps
    step = t_p + 2.0 * t_c
    u1 = 2.0 * t_c / step if step > 0 else 0.0
    denom = t_p * max(1.0, num_workers * u1) + 2.0 * t_c
    if denom <= 0:
        return 0.0
    return num_workers * batch_size / denom
