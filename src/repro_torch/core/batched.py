"""Lockstep batched scenario engine: structure-of-arrays simulation.

Fleet what-ifs and surrogate-assisted placement search want *millions* of
scenario evaluations; the scalar event-calendar engine costs ~7-10 us per
event in pure Python, almost all of it interpreter dispatch.  This module
advances thousands of **independent** scenarios in lockstep over flat
numpy state so that the per-event interpreter cost is amortized across the
whole batch:

  * **One event per scenario per iteration.**  Every scenario exposes its
    earliest pending event through a small candidate matrix ``cand[K, B]``
    (K = links + compute resources + a rejoin row, B = batch width); a
    pairwise ``np.minimum`` fold finds each scenario's next event and the
    whole batch advances together, each scenario on its own virtual-time
    column.
  * **Punt on ambiguity, never guess.**  The scalar engine drains
    *batches* of simultaneous events with kind-specific epsilon windows.
    Rather than replicate that machinery vectorized, a scenario whose
    second-earliest candidate falls within a conservative window of its
    earliest (``1e-9 + t * 1e-12``, a superset of every scalar epsilon) is
    *punted*: dropped from the batch and re-run from scratch on the scalar
    engine.  Results are never wrong, only slower.  With per-chunk service
    jitter enabled (every calibrated platform) ties are rare; fully
    deterministic workloads tie constantly and effectively fall back.
  * **Bit-identical float mirrors.**  Every arithmetic site mirrors the
    scalar engine expression-for-expression ((1/n)*B share-then-scale,
    division-form projections, virtual clocks materialized only where the
    scalar engine materializes), and RNG draws (``randrange`` step
    sampling, lognormal chunk jitter) call each scenario's own
    ``random.Random`` in the scalar draw order.  Batched traces are
    bit-identical to scalar traces — the differential harness in
    ``tests/test_batched_equivalence.py`` asserts exact equality, not
    approximate.

Scope (see :func:`classify`): async sync-mode, equal-share star bandwidth
(the paper's model), http2/fifo link policies, no topology object, no
fault injection, no per-op trace recording.  Everything else falls back
per-scenario to :class:`repro_torch.core.simulator.Simulation`.

The batched *waterfill* used by placement-search surrogate pruning lives
in ``repro_torch.core.bandwidth.batched_waterfill`` (numpy, or the same
arithmetic as torch ops); it is a scoring surrogate, not part of this
bit-exact engine.

The engine is host numpy, as the reference's is: float64 numpy arithmetic
is what keeps it bit-identical to the scalar engine's Python floats.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from .bandwidth import EqualShareModel
from .events import LINK, StepTemplate, Trace
from .simulator import SimConfig, Simulation, compile_template

__all__ = ["Scenario", "classify", "fallback_histogram", "run_scenarios"]

# Tie/punt window: a superset of every scalar batching epsilon
# (_EPS_COMPUTE = 1e-9, _EPS_REJOIN = 1e-15, _EPS_LINK = 1e-15 + t*1e-15).
_TIE_ABS = 1e-9
_TIE_REL = 1e-12
# Link drain threshold, exactly the scalar engine's v_lim arithmetic.
_WORK_EPS = 1e-9
_V_REL = 1e-12

_INF = float("inf")


@dataclass
class Scenario:
    """One simulation task: the arguments of ``Simulation(cfg).run(...)``."""

    cfg: SimConfig
    steps: Sequence[StepTemplate]
    num_workers: int
    sample: bool = True


def classify(cfg: SimConfig, num_workers: int) -> Optional[str]:
    """``None`` if the scenario is batchable, else the fallback reason.

    The batched engine handles the paper's core regime: asynchronous PS
    training on the uniform equal-share star.  Everything else runs on
    the scalar engine (which is the correctness reference anyway).
    """
    if cfg.sync_mode != "async":
        return f"sync_mode={cfg.sync_mode!r} (barrier state machine)"
    if cfg.faults is not None and not cfg.faults.empty():
        return "fault injection"
    if cfg.topology is not None:
        return "explicit topology"
    if type(cfg.bandwidth_model) is not EqualShareModel:
        return "non-uniform bandwidth model (general waterfill path)"
    if cfg.link_policy not in ("http2", "fifo"):
        return f"link_policy={cfg.link_policy!r}"
    if cfg.record_trace or cfg.record_op_times or cfg.record_rates:
        return "per-op trace recording"
    if cfg.worker_speed or cfg.res_speed:
        return "heterogeneous compute speeds"
    if cfg.seed is None:
        return "unseeded RNG (no reproducible stream to replicate)"
    if num_workers < 1:
        return "num_workers < 1"
    return None


def _fallback_category(reason: str) -> str:
    """Fold a free-text fallback reason into a stable category so sweeps
    (fleet mixes especially) can aggregate *why* scenarios rode the scalar
    path without parsing prose: barrier | faults | topology | hetero |
    policy | trace | unseeded | degenerate | forced | group-size | punt."""
    if reason.startswith("sync_mode="):
        return "barrier"
    if reason == "fault injection":
        return "faults"
    if reason in ("explicit topology",
                  "non-uniform bandwidth model (general waterfill path)"):
        return "topology"
    if reason == "heterogeneous compute speeds":
        return "hetero"
    if reason.startswith("link_policy="):
        return "policy"
    if reason == "per-op trace recording":
        return "trace"
    if reason.startswith("unseeded"):
        return "unseeded"
    if reason in ("num_workers < 1", "no steps"):
        return "degenerate"
    if reason == "forced scalar":
        return "forced"
    if "min_batch" in reason:
        return "group-size"
    if reason.startswith("punt:"):
        return "punt"
    return "other"


def fallback_histogram(traces: Sequence[Optional[Trace]]) -> Dict[str, int]:
    """Per-category counts of scalar fallbacks over a result list (the
    ``meta["batch_fallback_reason"]`` categories of :func:`run_scenarios`)."""
    hist: Dict[str, int] = {}
    for tr in traces:
        if tr is None:
            continue
        cat = tr.meta.get("batch_fallback_reason")
        if cat:
            hist[cat] = hist.get(cat, 0) + 1
    return hist


def _scalar_run(sc: Scenario, reason: str) -> Trace:
    tr = Simulation(sc.cfg).run(sc.steps, sc.num_workers, sample=sc.sample)
    tr.meta["engine"] = "scalar"
    tr.meta["batch_fallback"] = reason
    tr.meta["batch_fallback_reason"] = _fallback_category(reason)
    return tr


def _structure_key(sc: Scenario):
    res = sc.cfg.resources
    return (tuple(sorted((name, spec.kind) for name, spec in res.items())),
            tuple(id(s) for s in sc.steps),
            len(sc.steps))


class _TemplateBank:
    """Shared per-group template tables (structure-of-arrays form of the
    scalar engine's ``tpl_cache`` tuples, via ``compile_template``)."""

    def __init__(self, steps: Sequence[StepTemplate],
                 resources: Dict, res_index: Dict[str, int]):
        T = len(steps)
        O = max(len(s.ops) for s in steps)
        R = len(res_index)
        self.T, self.O = T, O
        self.t_res = np.zeros((T, O), np.int64)
        self.t_work = np.zeros((T, O), np.float64)
        self.t_nd = np.zeros((T, O), np.int64)
        self.t_nops = np.zeros(T, np.int64)
        deps_out: List[List[List[int]]] = []
        roots_all: List[List[int]] = []
        max_per_res = 0
        for t, tpl in enumerate(steps):
            ops, works, edges, roots = compile_template(tpl, resources)
            self.t_nops[t] = len(ops)
            per_res = [0] * R
            for i, op in enumerate(ops):
                ri = res_index[op.res]
                self.t_res[t, i] = ri
                self.t_work[t, i] = works[i]
                self.t_nd[t, i] = len(op.deps)
                per_res[ri] += 1
            max_per_res = max(max_per_res, max(per_res))
            dl: List[List[int]] = [[] for _ in range(O)]
            for d, i in edges:     # ascending dependent order (RNG order)
                dl[d].append(i)
            deps_out.append(dl)
            roots_all.append(roots)
        self.Smax = max((len(l) for dl in deps_out for l in dl), default=0)
        self.Rootmax = max(len(r) for r in roots_all)
        # slot s of op (t, o)'s dependent list, -1 when absent
        self.dep_slots = [np.full(T * O, -1, np.int64)
                          for _ in range(self.Smax)]
        for t, dl in enumerate(deps_out):
            for o, lst in enumerate(dl):
                for s, dep in enumerate(lst):
                    self.dep_slots[s][t * O + o] = dep
        self.root_slots = [np.full(T, -1, np.int64)
                           for _ in range(self.Rootmax)]
        for t, roots in enumerate(roots_all):
            for s, rt in enumerate(roots):
                self.root_slots[s][t] = rt
        self.t_res_flat = self.t_res.reshape(-1)
        # ring-buffer capacity: each op can be queued at most twice per
        # step on its resource (initial + one http2 requeue)
        self.QC = 2 * max_per_res + 2


_MT_N = 624
_MT_M = 397
_MT_UP = np.uint32(0x80000000)
_MT_LO = np.uint32(0x7FFFFFFF)
_MT_MAG = np.uint32(0x9908B0DF)
_TWOPI = 2.0 * math.pi
_RECIP53 = 1.0 / 9007199254740992.0   # 2**-53, exactly as CPython


class _BatchedMT:
    """B parallel MT19937 streams, bit-identical to ``random.Random``.

    Each row replicates one CPython ``random.Random(seed)``: the seeded
    key is lifted via ``getstate()`` and words come from a vectorized
    twist + temper.  ``random()`` double assembly, the ``getrandbits``
    rejection loop behind ``randrange``, and the Box-Muller ``gauss``
    (with its one-value cache) reproduce CPython's draw sequences word
    for word.  Only ``log`` falls back to per-element ``math.log``:
    numpy's SIMD float64 log/exp round differently from libm on this
    platform (verified at import sites), while cos/sin/sqrt and all
    arithmetic are IEEE-identical.
    """

    _base_key: Optional[np.ndarray] = None   # init_genrand(19650218)

    def __init__(self, seeds: Sequence) -> None:
        B = len(seeds)
        if all(isinstance(s, int) and 0 <= s < 2 ** 32 for s in seeds):
            key = self._seed_simple(np.array(seeds, np.uint32))
        else:
            key = np.empty((B, _MT_N), np.uint32)
            for b, seed in enumerate(seeds):
                key[b] = random.Random(seed).getstate()[1][:_MT_N]
        self.key = key
        self.buf = np.empty(B * _MT_N, np.uint32)
        self.pos = np.full(B, _MT_N, np.int64)    # fresh seed: index == N
        self.g_has = np.zeros(B, bool)            # gauss_next cache
        self.g_val = np.zeros(B)

    @classmethod
    def _seed_simple(cls, sv: np.ndarray) -> np.ndarray:
        """Vectorized CPython int-seed key schedule (one-word keys).

        Replicates ``init_by_array([seed])`` across all streams at once;
        the recurrence is sequential in the word index but each step is a
        vector op over the batch.  Verified word-for-word against
        ``random.Random(seed).getstate()`` by the differential tests.
        """
        if cls._base_key is None:
            mt = [0] * _MT_N
            mt[0] = 19650218            # init_genrand constant
            for i in range(1, _MT_N):
                mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30))
                         + i) & 0xFFFFFFFF
            cls._base_key = np.array(mt, np.uint32)
        key = np.empty((len(sv), _MT_N), np.uint32)
        key[:] = cls._base_key
        m1 = np.uint32(1664525)
        m2 = np.uint32(1566083941)
        s30 = np.uint32(30)
        # pass 1: N steps of mt[i] = (mt[i] ^ f(mt[i-1])*m1) + key[0]
        # (j stays 0 for a one-word key), wrapping i at N
        prev = key[:, 0].copy()
        for i in range(1, _MT_N):
            prev = (key[:, i] ^ ((prev ^ (prev >> s30)) * m1)) + sv
            key[:, i] = prev
        key[:, 0] = prev
        prev = (key[:, 1] ^ ((prev ^ (prev >> s30)) * m1)) + sv
        key[:, 1] = prev
        # pass 2: N-1 steps with multiplier m2 and a -i term
        i = 2
        for _ in range(_MT_N - 1):
            prev = (key[:, i] ^ ((prev ^ (prev >> s30)) * m2)) - np.uint32(i)
            key[:, i] = prev
            i += 1
            if i >= _MT_N:
                key[:, 0] = prev
                i = 1
        key[:, 0] = np.uint32(0x80000000)
        return key

    @staticmethod
    def _tw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        y = (a & _MT_UP) | (b & _MT_LO)
        return (y >> np.uint32(1)) ^ ((y & np.uint32(1)) * _MT_MAG)

    def _refill(self, rows: np.ndarray) -> None:
        old = self.key[rows]
        new = np.empty_like(old)
        # reference genrand twist, in the four blocks whose inputs are
        # already settled (old snapshot for y-parts, new for xor-parts)
        new[:, 0:227] = old[:, 397:624] ^ self._tw(old[:, 0:227],
                                                   old[:, 1:228])
        new[:, 227:454] = new[:, 0:227] ^ self._tw(old[:, 227:454],
                                                   old[:, 228:455])
        new[:, 454:623] = new[:, 227:396] ^ self._tw(old[:, 454:623],
                                                     old[:, 455:624])
        new[:, 623] = new[:, 396] ^ self._tw(old[:, 623], new[:, 0])
        self.key[rows] = new
        y = new   # temper in place (new is a scratch copy)
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        b2 = self.buf.reshape(-1, _MT_N)
        b2[rows] = y
        self.pos[rows] = 0

    def _words(self, sel: np.ndarray) -> np.ndarray:
        """One raw 32-bit output per selected stream (rows unique)."""
        pos = self.pos
        p = pos[sel]
        need = p >= _MT_N
        if need.any():
            self._refill(sel[np.nonzero(need)[0]])
            p = pos[sel]
        w = self.buf[sel * _MT_N + p]
        pos[sel] = p + 1
        return w

    def random_(self, sel: np.ndarray) -> np.ndarray:
        """CPython ``random()``: (a*2**26 + b) * 2**-53, two words."""
        a = self._words(sel) >> np.uint32(5)
        b = self._words(sel) >> np.uint32(6)
        return (a * 67108864.0 + b) * _RECIP53

    def random2_(self, sel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Two consecutive ``random()`` doubles per stream (four words).

        Fast path gathers all four words in one stride when no stream
        straddles its buffer end; the slow path (≤ 4/624 of calls)
        defers to the single-word reader.
        """
        pos = self.pos
        p = pos[sel]
        if (p > _MT_N - 4).any():
            return self.random_(sel), self.random_(sel)
        base = sel * _MT_N + p
        buf = self.buf
        a1 = buf[base] >> np.uint32(5)
        b1 = buf[base + 1] >> np.uint32(6)
        a2 = buf[base + 2] >> np.uint32(5)
        b2 = buf[base + 3] >> np.uint32(6)
        pos[sel] = p + 4
        return ((a1 * 67108864.0 + b1) * _RECIP53,
                (a2 * 67108864.0 + b2) * _RECIP53)

    def gauss(self, sel: np.ndarray, mu: np.ndarray,
              sigma: np.ndarray) -> np.ndarray:
        z = self.g_val[sel]
        has = self.g_has[sel]
        self.g_has[sel] = False
        if not has.all():
            f = np.nonzero(~has)[0]
            sf = sel[f]
            u1, u2 = self.random2_(sf)
            x2pi = u1 * _TWOPI
            arg = 1.0 - u2
            lg = np.fromiter(map(math.log, arg.tolist()),
                             np.float64, len(arg))
            g2rad = np.sqrt(-2.0 * lg)
            z[f] = np.cos(x2pi) * g2rad
            self.g_val[sf] = np.sin(x2pi) * g2rad
            self.g_has[sf] = True
        return mu + z * sigma

    def randrange(self, sel: np.ndarray, n: int) -> np.ndarray:
        """CPython ``_randbelow_with_getrandbits``: top-bits + rejection."""
        k = np.uint32(32 - n.bit_length())
        r = self._words(sel) >> k
        bad = r >= n
        while bad.any():
            bx = np.nonzero(bad)[0]
            r[bx] = self._words(sel[bx]) >> k
            bad[bx] = r[bx] >= n
        return r.astype(np.int64)


class _LockstepBatch:
    """One homogeneous-structure batch advanced in lockstep."""

    def __init__(self, scens: List[Scenario]):
        self.scens = scens
        B = len(scens)
        self.B = B
        res = scens[0].cfg.resources
        self.link_names = sorted(n for n, s in res.items() if s.kind == LINK)
        self.comp_names = sorted(n for n, s in res.items() if s.kind != LINK)
        self.RL = len(self.link_names)
        self.RC = len(self.comp_names)
        self.R = self.RL + self.RC
        self.res_index = {n: i for i, n in
                          enumerate(self.link_names + self.comp_names)}
        self.bank = _TemplateBank(scens[0].steps, res, self.res_index)
        self.O = self.bank.O
        self.QC = self.bank.QC
        self.T = self.bank.T
        self.Wmax = max(sc.num_workers for sc in scens)
        # candidate rows: links, compute resources, rejoin
        self.K = self.RL + self.RC + 1

        # ---- per-scenario parameters ----
        self.W_a = np.array([sc.num_workers for sc in scens], np.int64)
        self.spw_l = [sc.cfg.steps_per_worker for sc in scens]
        self.total_l = [sc.num_workers * sc.cfg.steps_per_worker
                        for sc in scens]
        self.win = np.array([sc.cfg.win for sc in scens])
        self.stall = np.array(
            [sc.cfg.stall_alpha * sc.cfg.win + sc.cfg.stall_rtt
             for sc in scens])
        self.jsig = np.array([sc.cfg.service_jitter for sc in scens])
        self.jmu = np.array([-0.5 * s * s for s in self.jsig.tolist()])
        self.jpos = self.jsig > 0.0
        self.all_jitter = bool(self.jpos.all())
        self.spos = self.stall > 0.0
        self.http2 = np.array([sc.cfg.link_policy == "http2"
                               for sc in scens], bool)
        self.samp = np.array([sc.sample for sc in scens], bool)
        self.mt = _BatchedMT([sc.cfg.seed for sc in scens])
        bw = np.zeros(B * self.RL)
        for k, sc in enumerate(scens):
            for li, name in enumerate(self.link_names):
                bw[k * self.RL + li] = sc.cfg.resources[name].bandwidth
        self.l_bw = bw

        Wmax, O, R, RL, RC, QC = (self.Wmax, self.O, self.R,
                                  self.RL, self.RC, self.QC)
        # ---- per-op / per-pair / per-link state ----
        self.o_nd = np.zeros(B * Wmax * O, np.int64)
        self.o_rw = np.zeros(B * Wmax * O)
        self.o_svc = np.zeros(B * Wmax * O, bool)
        self.o_nd2 = self.o_nd.reshape(B * Wmax, O)
        self.o_rw2 = self.o_rw.reshape(B * Wmax, O)
        self.o_svc2 = self.o_svc.reshape(B * Wmax, O)
        self.cur_tpl = np.zeros(B * Wmax, np.int64)
        self.p_pend = np.zeros(B * Wmax, np.int64)
        self.p_run = np.full(B * Wmax * R, -1, np.int64)
        self.p_last = np.zeros(B * Wmax * R, bool)
        self.q_buf = np.zeros(B * Wmax * R * QC, np.int16)
        self.q_head = np.zeros(B * Wmax * R, np.int64)
        self.q_tail = np.zeros(B * Wmax * R, np.int64)
        self.q_head2 = self.q_head.reshape(B * Wmax, R)
        self.q_tail2 = self.q_tail.reshape(B * Wmax, R)
        self.l_V = np.zeros(B * RL)
        self.l_rate = np.zeros(B * RL)
        self.l_tmat = np.zeros(B * RL)
        self.l_n = np.zeros(B * RL, np.int64)
        self.l_dirty = np.zeros(B * RL, bool)
        # int64 division is slow on this interpreter; precompute the
        # (scenario, link) decomposition of a flat B*RL row index once.
        _rows = np.arange(B * RL, dtype=np.int64)
        self._row_i = _rows // RL
        self._row_li = _rows - self._row_i * RL
        self.l_vt = np.full(B * RL * Wmax, _INF)
        self.l_act = np.zeros(B * RL * Wmax, bool)
        self.l_headv = np.full(B * RL, _INF)
        self.l_headw = np.full(B * RL, -1, np.int64)
        self.c_vt = np.full(B * RC * Wmax, _INF)
        self.c_headv = np.full(B * RC, _INF)
        self.c_headw = np.full(B * RC, -1, np.int64)
        self.cand = np.full((self.K, B), _INF)
        self.cand_flat = self.cand.reshape(-1)
        self.t_cur = np.zeros(B)
        self.active = np.ones(B, bool)
        self.n_ev = np.zeros(B, np.int64)
        # analytic chunk-completion count per (scenario, template): one
        # chunk per op, plus one for each http2-carved link op (the
        # scheduler carves at most once); accrued per step at start time
        # so the hot completion path never touches the counter
        T, O = self.T, self.O
        evc = np.empty((B, T), np.int64)
        for tn in range(T):
            no = int(self.bank.t_nops[tn])
            lw = np.sort(np.array(
                [self.bank.t_work[tn, o] for o in range(no)
                 if self.bank.t_res_flat[tn * O + o] < RL]))
            extra = len(lw) - np.searchsorted(lw, self.win, side="right")
            evc[:, tn] = no + np.where(self.http2, extra, 0)
        self.evc_flat = evc.reshape(-1)

        # ---- rejoin FIFO rings: t_cur is monotone and the stall is a
        # per-scenario constant, so rejoins arrive in non-decreasing time
        # order and a sorted ring replaces a heap ----
        self.Qr = Wmax * RL * max(1, (QC - 2) // 2) + 1
        Qr = self.Qr
        self.rj_td = np.zeros(B * Qr)
        self.rj_w = np.zeros(B * Qr, np.int64)
        self.rj_r = np.zeros(B * Qr, np.int64)
        self.rj_op = np.zeros(B * Qr, np.int64)
        self.rj_head = np.zeros(B, np.int64)   # wrapped ring indices
        self.rj_tail = np.zeros(B, np.int64)
        self.rj_n = np.zeros(B, np.int64)

        # ---- step lifecycle (vectorized SyncController, async mode) ----
        self.completed = np.zeros(B * Wmax, np.int64)
        self.sample_idx = np.zeros(B * Wmax, np.int64)
        self.sdone = np.zeros(B, np.int64)
        self.version = np.zeros(B, np.int64)
        self.v_start = np.zeros(B * Wmax, np.int64)
        self.total_a = np.array(self.total_l, np.int64)
        self.spw_a = np.array(self.spw_l, np.int64)
        # global completion log, split per scenario at trace assembly
        # (iteration order == per-scenario time order == scalar order)
        self.log_i: List[int] = []
        self.log_w: List[int] = []
        self.log_seq: List[int] = []
        self.log_t: List[float] = []
        self.log_lag: List[int] = []
        self.end_t = [0.0] * B
        self.punted: Dict[int, str] = {}
        max_ops = int(self.bank.t_nops.max())
        self.max_iters = 200 * max(self.total_l) * max(1, max_ops) \
            + 200 * B + 10_000

    # -- small vector helpers ------------------------------------------------

    def _recompute_head(self, vt: np.ndarray, rows: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        base = rows * self.Wmax
        hv = vt[base]
        hw = np.zeros(len(rows), np.int64)
        for w in range(1, self.Wmax):
            col = vt[base + w]
            lt = col < hv
            np.minimum(hv, col, out=hv)
            np.putmask(hw, lt, w)
        np.putmask(hw, np.isinf(hv), -1)
        return hv, hw

    def _punt(self, idx: np.ndarray, reason: str) -> None:
        if len(idx) == 0:
            return
        self.active[idx] = False
        self.cand[:, idx] = _INF
        RL = self.RL
        for i in idx.tolist():
            self.punted.setdefault(i, reason)
            self.l_dirty[i * RL:(i + 1) * RL] = False

    def _retire(self, i: int, t: float) -> None:
        self.active[i] = False
        self.end_t[i] = t
        self.cand[:, i] = _INF
        self.l_dirty[i * self.RL:(i + 1) * self.RL] = False

    # -- chunk service -------------------------------------------------------

    def _begin(self, i, w, r, op, lin_pair, lin_wo) -> None:
        """Place chunks on idle pairs (at most one entry per scenario)."""
        t = self.t_cur[i]
        lin_op = lin_wo * self.O + op
        self.p_run[lin_pair] = op
        isl = r < self.RL
        # single-template workloads release homogeneous waves (all-link or
        # all-compute); skip the subset gathers on those fast paths
        if isl.all():
            self._begin_links(i, w, r, op, lin_pair, lin_op, t)
        elif not isl.any():
            self._begin_comps(i, w, r, op, lin_pair, lin_op, t)
        else:
            l = np.nonzero(isl)[0]
            self._begin_links(i[l], w[l], r[l], op[l], lin_pair[l],
                              lin_op[l], t[l])
            c = np.nonzero(~isl)[0]
            self._begin_comps(i[c], w[c], r[c], op[c], lin_pair[c],
                              lin_op[c], t[c])

    def _begin_links(self, il, wl, rl, op, lp, lol, tl) -> None:
        if len(il) == 0:
            return
        win = self.win[il]
        rw = self.o_rw[lol]
        carve = self.http2[il] & ~self.o_svc[lol] & (rw > win)
        rem = rw
        if carve.any():
            c = np.nonzero(carve)[0]
            lc = lol[c]
            self.o_svc[lc] = True
            self.o_rw[lc] = rw[c] - win[c]
            rem = rw.copy()
            rem[c] = win[c]
        # lognormal per-chunk service jitter, one scenario at a time in
        # scalar draw order (the caller guarantees one entry/scenario)
        if self.all_jitter:
            val = self.mt.gauss(il, self.jmu[il], self.jsig[il])
            rem = rem * np.fromiter(map(math.exp, val.tolist()),
                                    np.float64, len(val))
        else:
            jl = np.nonzero(self.jpos[il])[0]
            if len(jl):
                fac = np.ones(len(il))
                ij = il[jl]
                val = self.mt.gauss(ij, self.jmu[ij], self.jsig[ij])
                fac[jl] = list(map(math.exp, val.tolist()))
                rem = rem * fac
        lin_l = il * self.RL + rl
        self.l_V[lin_l] += self.l_rate[lin_l] * (tl - self.l_tmat[lin_l])
        self.l_tmat[lin_l] = tl
        v = self.l_V[lin_l] + rem
        law = lin_l * self.Wmax + wl
        self.l_vt[law] = v
        # idempotent set-add: a worker chaining straight into its next
        # chunk on the same link never left the active set
        self.l_n[lin_l] += ~self.l_act[law]
        self.l_act[law] = True
        self.l_dirty[lin_l] = True
        lt = v < self.l_headv[lin_l]
        if lt.any():
            u = np.nonzero(lt)[0]
            self.l_headv[lin_l[u]] = v[u]
            self.l_headw[lin_l[u]] = wl[u]
        self.p_last[lp] = ~carve

    def _begin_comps(self, ic, wc, r, op, lp, lol, tc0) -> None:
        if len(ic) == 0:
            return
        rc = r - self.RL
        tc = tc0 + self.o_rw[lol]
        lin_c = ic * self.RC + rc
        self.c_vt[lin_c * self.Wmax + wc] = tc
        lt = tc < self.c_headv[lin_c]
        if lt.any():
            u = np.nonzero(lt)[0]
            lcu = lin_c[u]
            self.c_headv[lcu] = tc[u]
            self.c_headw[lcu] = wc[u]
            self.cand_flat[(self.RL + rc[u]) * self.B + ic[u]] = tc[u]
        self.p_last[lp] = True

    def _enqueue(self, i, w, r, op) -> None:
        """Scheduler add + try_start_chunk (one entry per scenario)."""
        lin_wo = i * self.Wmax + w
        lin_pair = lin_wo * self.R + r
        busy = self.p_run[lin_pair] >= 0
        # a pair the completing chunk just left may still hold queued work
        # (a dependent released onto its own resource): the op joins the
        # back of the queue and the queue's head starts, as the scalar
        # add + try_start_chunk does
        waiting = self.q_tail[lin_pair] > self.q_head[lin_pair]
        add = busy | waiting
        if add.any():
            b = np.nonzero(add)[0]
            lp = lin_pair[b]
            pos = self.q_tail[lp]
            self.q_buf[lp * self.QC + pos] = op[b]
            self.q_tail[lp] = pos + 1
        if not busy.all():
            d = np.nonzero(~busy)[0]
            op_d = op[d]
            h = np.nonzero(waiting[d])[0]
            if len(h):
                lp = lin_pair[d[h]]
                pos = self.q_head[lp]
                op_d[h] = self.q_buf[lp * self.QC + pos]
                self.q_head[lp] = pos + 1
            self._begin(i[d], w[d], r[d], op_d, lin_pair[d], lin_wo[d])

    # -- step lifecycle ------------------------------------------------------

    def _start_steps(self, i: np.ndarray, w: np.ndarray) -> None:
        lwo = i * self.Wmax + w
        self.v_start[lwo] = self.version[i]     # on_step_start
        sm = self.samp[i]
        if sm.all():
            tids = self.mt.randrange(i, self.T)
        else:
            tids = np.zeros(len(i), np.int64)
            sx = np.nonzero(sm)[0]
            if len(sx):
                tids[sx] = self.mt.randrange(i[sx], self.T)
            cy = np.nonzero(~sm)[0]
            lc = lwo[cy]
            tids[cy] = self.sample_idx[lc] % self.T
            self.sample_idx[lc] += 1
        self.cur_tpl[lwo] = tids
        self.n_ev[i] += self.evc_flat[i * self.T + tids]
        self.o_nd2[lwo] = self.bank.t_nd[tids]
        self.o_rw2[lwo] = self.bank.t_work[tids]
        self.o_svc2[lwo] = False
        self.q_head2[lwo] = 0
        self.q_tail2[lwo] = 0
        self.p_pend[lwo] = self.bank.t_nops[tids]
        for s in range(self.bank.Rootmax):
            rop = self.bank.root_slots[s][tids]
            m = np.nonzero(rop >= 0)[0]
            if len(m):
                dq = rop[m]
                rq = self.bank.t_res_flat[tids[m] * self.O + dq]
                self._enqueue(i[m], w[m], rq, dq)

    def _steps_complete(self, i: np.ndarray, w: np.ndarray) -> None:
        # one completion per scenario per iteration (i rows are unique),
        # so the scenario-level counters update without conflict
        lwo = i * self.Wmax + w
        comp = self.completed[lwo] + 1
        self.completed[lwo] = comp
        self.sdone[i] += 1
        lag = self.version[i] - self.v_start[lwo]
        self.version[i] += 1
        t = self.t_cur[i]
        # append array refs (all freshly computed); concatenated once at
        # trace-assembly time instead of paying tolist+extend per iteration
        self.log_i.append(i)
        self.log_w.append(w)
        self.log_seq.append(comp - 1)
        self.log_t.append(t)
        self.log_lag.append(lag)
        starts = comp < self.spw_a[i]
        done = ~starts & (self.sdone[i] == self.total_a[i])
        if done.any():
            for k in np.nonzero(done)[0].tolist():
                self._retire(int(i[k]), float(t[k]))
        st = np.nonzero(starts)[0]
        if len(st):
            self._start_steps(i[st], w[st])

    # -- event firing --------------------------------------------------------

    def _fire_links(self, i: np.ndarray, li: np.ndarray):
        empty = (np.empty(0, np.int64),) * 6
        if len(i) == 0:
            return empty
        lin_l = i * self.RL + li
        t = self.t_cur[i]
        self.l_V[lin_l] += self.l_rate[lin_l] * (t - self.l_tmat[lin_l])
        self.l_tmat[lin_l] = t
        V = self.l_V[lin_l]
        vlim = (V + _WORK_EPS) + V * _V_REL
        hv = self.l_headv[lin_l]
        hw = self.l_headw[lin_l]
        bad = (hw < 0) | (hv > vlim)
        if bad.any():
            self._punt(i[np.nonzero(bad)[0]], "link head not due")
            g = np.nonzero(~bad)[0]
            if len(g) == 0:
                return empty
            i, li, lin_l, hw, vlim = i[g], li[g], lin_l[g], hw[g], vlim[g]
        self.l_vt[lin_l * self.Wmax + hw] = _INF
        nh, nw = self._recompute_head(self.l_vt, lin_l)
        self.l_headv[lin_l] = nh
        self.l_headw[lin_l] = nw
        md = nh <= vlim
        if md.any():
            self._punt(i[np.nonzero(md)[0]], "simultaneous link completions")
            g = np.nonzero(~md)[0]
            if len(g) == 0:
                return empty
            i, li, lin_l, hw = i[g], li[g], lin_l[g], hw[g]
        self.l_dirty[lin_l] = True
        lwo = i * self.Wmax + hw
        lp = lwo * self.R + li
        op = self.p_run[lp]
        return i, hw, li, op, lwo, lp

    def _fire_computes(self, i: np.ndarray, rows: np.ndarray):
        empty = (np.empty(0, np.int64),) * 6
        if len(i) == 0:
            return empty
        rc = rows - self.RL
        lin_c = i * self.RC + rc
        hw = self.c_headw[lin_c]
        bad = hw < 0
        if bad.any():
            self._punt(i[np.nonzero(bad)[0]], "compute head missing")
            g = np.nonzero(~bad)[0]
            if len(g) == 0:
                return empty
            i, rc, lin_c, hw = i[g], rc[g], lin_c[g], hw[g]
        t = self.t_cur[i]
        self.c_vt[lin_c * self.Wmax + hw] = _INF
        nh, nw = self._recompute_head(self.c_vt, lin_c)
        self.c_headv[lin_c] = nh
        self.c_headw[lin_c] = nw
        self.cand_flat[(self.RL + rc) * self.B + i] = nh
        md = nh <= (t + _TIE_ABS) + t * _TIE_REL
        if md.any():
            self._punt(i[np.nonzero(md)[0]],
                       "simultaneous compute completions")
            g = np.nonzero(~md)[0]
            if len(g) == 0:
                return empty
            i, rc, hw = i[g], rc[g], hw[g]
        r = rc + self.RL
        lwo = i * self.Wmax + hw
        lp = lwo * self.R + r
        op = self.p_run[lp]
        return i, hw, r, op, lwo, lp

    def _fire_rejoins(self, i: np.ndarray):
        """Pop each scenario's due rejoin; returns the enqueue arrays."""
        empty = (np.empty(0, np.int64),) * 4
        if len(i) == 0:
            return empty
        Qr = self.Qr
        hd = self.rj_head[i]
        slot = i * Qr + hd
        w = self.rj_w[slot]
        r = self.rj_r[slot]
        op = self.rj_op[slot]
        nh = hd + 1
        np.putmask(nh, nh == Qr, 0)
        self.rj_head[i] = nh
        cnt = self.rj_n[i] - 1
        self.rj_n[i] = cnt
        # next-due entry is the new ring front (pushes are time-ordered)
        ntd = np.where(cnt > 0, self.rj_td[i * Qr + nh], _INF)
        self.cand[self.K - 1, i] = ntd
        t = self.t_cur[i]
        md = ntd <= (t + _TIE_ABS) + t * _TIE_REL
        if md.any():
            self._punt(i[np.nonzero(md)[0]], "simultaneous rejoins")
            g = np.nonzero(~md)[0]
            if len(g) == 0:
                return empty
            i, w, r, op = i[g], w[g], r[g], op[g]
        return i, w, r, op

    # -- completion pipeline -------------------------------------------------

    def _complete(self, i, w, r, op, lin_wo, lin_pair) -> None:
        Wmax, R, O = self.Wmax, self.R, self.O
        last = self.p_last[lin_pair]
        self.p_run[lin_pair] = -1
        t = self.t_cur[i]
        # non-last chunk: rejoin after the WINDOW_UPDATE stall, or requeue
        # immediately when stall == 0
        nl = ~last
        n = np.nonzero(nl)[0]
        if len(n):
            sp = self.spos[i[n]]
            z = n[np.nonzero(sp)[0]]
            if len(z):
                iz = i[z]
                td = t[z] + self.stall[iz]
                crow = self.cand[self.K - 1]
                crow[iz] = np.minimum(crow[iz], td)
                Qr = self.Qr
                tl_ = self.rj_tail[iz]
                slot = iz * Qr + tl_
                self.rj_td[slot] = td
                self.rj_w[slot] = w[z]
                self.rj_r[slot] = r[z]
                self.rj_op[slot] = op[z]
                tl_ = tl_ + 1
                np.putmask(tl_, tl_ == Qr, 0)
                self.rj_tail[iz] = tl_
                self.rj_n[iz] += 1
            z = n[np.nonzero(~sp)[0]]
            if len(z):
                lp = lin_pair[z]
                pos = self.q_tail[lp]
                self.q_buf[lp * self.QC + pos] = op[z]
                self.q_tail[lp] = pos + 1
        # last chunk: op done — release dependents in ascending-index order
        la = np.nonzero(last)[0]
        if len(la):
            lwo = lin_wo[la]
            self.p_pend[lwo] -= 1
            tid = self.cur_tpl[lwo]
            tob = tid * O + op[la]
            i_la = i[la]
            w_la = w[la]
            for s in range(self.bank.Smax):
                dep = self.bank.dep_slots[s][tob]
                m = np.nonzero(dep >= 0)[0]
                if len(m) == 0:
                    continue
                ld = lwo[m] * O + dep[m]
                nd = self.o_nd[ld] - 1
                self.o_nd[ld] = nd
                q = m[np.nonzero(nd == 0)[0]]
                if len(q):
                    dq = dep[q]
                    rq = self.bank.t_res_flat[tid[q] * O + dq]
                    self._enqueue(i_la[q], w_la[q], rq, dq)
        # next chunk on this pair (a dependent may have claimed it)
        free = self.p_run[lin_pair] < 0
        qa = self.q_tail[lin_pair] > self.q_head[lin_pair]
        sx = np.nonzero(free & qa)[0]
        if len(sx):
            lp = lin_pair[sx]
            pos = self.q_head[lp]
            op2 = self.q_buf[lp * self.QC + pos].astype(np.int64)
            self.q_head[lp] = pos + 1
            self._begin(i[sx], w[sx], r[sx], op2, lp, lin_wo[sx])
        lx = np.nonzero(free & ~qa & (r < self.RL))[0]
        if len(lx):
            ll = i[lx] * self.RL + r[lx]
            self.l_act[ll * Wmax + w[lx]] = False
            self.l_n[ll] -= 1
            self.l_dirty[ll] = True
        # step complete?
        dx = np.nonzero(self.p_pend[lin_wo] == 0)[0]
        if len(dx):
            self._steps_complete(i[dx], w[dx])

    # -- rate refresh (scalar finalize_batch, uniform path) ------------------

    def _finalize(self) -> None:
        d = np.nonzero(self.l_dirty)[0]
        if len(d) == 0:
            return
        i = self._row_i[d]
        li = self._row_li[d]
        t = self.t_cur[i]
        self.l_V[d] += self.l_rate[d] * (t - self.l_tmat[d])
        self.l_tmat[d] = t
        n = self.l_n[d]
        nf = n.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = (1.0 / nf) * self.l_bw[d]     # share-then-scale
            np.putmask(rate, n == 0, 0.0)
            self.l_rate[d] = rate
            hv = self.l_headv[d]
            dt = (hv - self.l_V[d]) / rate
        proj = t + np.where(dt > 0.0, dt, 0.0)
        ok = np.isfinite(hv) & (rate > 0.0)
        np.putmask(proj, ~ok, _INF)
        self.cand_flat[li * self.B + i] = proj
        self.l_dirty.fill(False)

    # -- main loop -----------------------------------------------------------

    def run(self) -> Tuple[Dict[int, Trace], Dict[int, str]]:
        B, K, RL = self.B, self.K, self.RL
        # t = 0: every worker starts its first step, then one finalize
        for w in range(self.Wmax):
            sel = np.nonzero(self.W_a > w)[0]
            if len(sel):
                self._start_steps(sel, np.full(len(sel), w, np.int64))
        self._finalize()

        cand = self.cand
        m1 = np.empty(B)
        m2 = np.empty(B)
        wrow = np.empty(B, np.int64)
        lt = np.empty(B, bool)
        bt = np.empty(B, bool)
        lim = np.empty(B)
        tmp = np.empty(B)
        iters = 0
        while self.active.any():
            iters += 1
            if iters > self.max_iters:
                self._punt(np.nonzero(self.active)[0], "iteration guard")
                break
            # two-smallest candidates + argmin row per scenario (pairwise
            # fold: axis reductions are pathological on small-core builds
            # of numpy)
            np.copyto(m1, cand[0])
            m2.fill(_INF)
            wrow.fill(0)
            for k in range(1, K):
                row = cand[k]
                np.less(row, m1, out=lt)
                np.minimum(m2, np.maximum(m1, row), out=m2)
                np.minimum(m1, row, out=m1)
                np.putmask(wrow, lt, k)
            # punt scenarios whose runner-up falls inside the tie window
            np.multiply(m1, _TIE_REL, out=tmp)
            np.add(tmp, _TIE_ABS, out=tmp)
            np.add(m1, tmp, out=lim)
            np.isinf(m1, out=bt)
            np.logical_and(bt, self.active, out=bt)
            if bt.any():
                self._punt(np.nonzero(bt)[0], "no runnable event")
            np.less_equal(m2, lim, out=bt)
            np.logical_and(bt, self.active, out=bt)
            if bt.any():
                self._punt(np.nonzero(bt)[0], "simultaneous events")
            # punts above cleared their active bits, and every remaining
            # active scenario has a finite earliest candidate
            pi = np.nonzero(self.active)[0]
            if len(pi) == 0:
                continue
            self.t_cur[pi] = np.maximum(self.t_cur[pi], m1[pi])
            wr = wrow[pi]
            # due rejoins re-enter their link queue (scalar batch order:
            # rejoins before completions; disjoint scenarios here)
            rj = wr == K - 1
            ri, rw_, rr, rop = self._fire_rejoins(pi[rj])
            if len(ri):
                self._enqueue(ri, rw_, rr, rop)
            lk = wr < RL
            cp = ~lk & ~rj
            lres = self._fire_links(pi[lk], wr[lk])
            cres = self._fire_computes(pi[cp], wr[cp])
            if len(lres[0]) == 0:
                if len(cres[0]):
                    self._complete(*cres)
            elif len(cres[0]) == 0:
                self._complete(*lres)
            else:
                self._complete(*(np.concatenate([a, b])
                                 for a, b in zip(lres, cres)))
            self._finalize()

        # split the global completion log back into per-scenario traces
        # (append order == per-scenario completion order == scalar order;
        # the stable sort keeps that order within each scenario)
        scomp: List[List[Tuple[int, int, float]]] = [[] for _ in range(B)]
        stal: List[List[int]] = [[] for _ in range(B)]
        if self.log_i:
            li = np.concatenate(self.log_i)
            order = np.argsort(li, kind="stable")
            lw_s = np.concatenate(self.log_w)[order].tolist()
            ls_s = np.concatenate(self.log_seq)[order].tolist()
            lt_s = np.concatenate(self.log_t)[order].tolist()
            ll_s = np.concatenate(self.log_lag)[order].tolist()
            counts = np.bincount(li, minlength=B)
            offs = np.concatenate(([0], np.cumsum(counts))).tolist()
            for k in range(B):
                a, b = offs[k], offs[k + 1]
                if a != b:
                    scomp[k] = list(zip(lw_s[a:b], ls_s[a:b], lt_s[a:b]))
                    stal[k] = ll_s[a:b]
        traces: Dict[int, Trace] = {}
        for k in range(B):
            if k in self.punted:
                continue
            sc = self.scens[k]
            tr = Trace()
            tr.step_completions = scomp[k]
            tr.staleness = stal[k]
            tr.meta = {  # type: ignore[attr-defined]
                "num_workers": sc.num_workers,
                "steps_per_worker": sc.cfg.steps_per_worker,
                "sim_end_time": self.end_t[k],
                "num_events": int(self.n_ev[k]),
                "sync_mode": "async",
                "num_versions": int(self.version[k]),
                "barrier_commits": [],
                "engine": "batched",
            }
            traces[k] = tr
        return traces, self.punted


def _mem_per_scenario(Wmax: int, O: int, R: int, RL: int, RC: int,
                      QC: int) -> int:
    return (Wmax * O * (8 + 8 + 1)             # op state
            + Wmax * R * (QC * 2 + 8 + 8 + 8 + 1)   # queues + pair state
            + RL * (8 * 5 + 8 + 1) + Wmax * RL * 8  # link state
            + RC * (8 + 8) + Wmax * RC * 8          # compute heads
            + (RL + RC + 1) * 8 + 64                # candidates + misc
            + _MT_N * 4 * 2)                        # MT key + output buffer


def run_scenarios(scenarios: Sequence[Scenario], engine: str = "auto",
                  min_batch: int = 2, max_batch: int = 4096,
                  max_mem_bytes: int = 256 << 20) -> List[Trace]:
    """Run scenarios, batching compatible ones in lockstep.

    Returns one :class:`Trace` per scenario, in input order, bit-identical
    to ``Simulation(cfg).run(steps, num_workers, sample=...)``.  Each
    trace's ``meta["engine"]`` reports how it actually ran: ``"batched"``
    or ``"scalar"`` (with ``meta["batch_fallback"]`` naming the reason —
    an unbatchable configuration, a too-small group, or a mid-run punt on
    ambiguous event ordering — and ``meta["batch_fallback_reason"]`` its
    stable category: barrier | faults | topology | hetero | policy |
    trace | unseeded | degenerate | forced | group-size | punt).

    ``engine="scalar"`` forces the scalar path (differential baseline);
    ``"auto"`` batches whatever qualifies.
    """
    if engine not in ("auto", "scalar"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'auto' or 'scalar')")
    out: List[Optional[Trace]] = [None] * len(scenarios)
    groups: Dict[object, List[int]] = {}
    for idx, sc in enumerate(scenarios):
        reason = ("forced scalar" if engine == "scalar"
                  else (classify(sc.cfg, sc.num_workers)
                        if sc.steps else "no steps"))
        if reason is not None:
            out[idx] = _scalar_run(sc, reason)
            continue
        groups.setdefault(_structure_key(sc), []).append(idx)
    for key, members in groups.items():
        if len(members) < min_batch:
            for idx in members:
                out[idx] = _scalar_run(
                    scenarios[idx], f"group of {len(members)} < min_batch")
            continue
        # split oversized groups so state fits the memory budget
        probe = _LockstepBatch([scenarios[members[0]],
                                scenarios[members[-1]]])
        w_all = max(scenarios[idx].num_workers for idx in members)
        per = _mem_per_scenario(w_all, probe.O, probe.R, probe.RL,
                                probe.RC, probe.QC)
        cap = max(min_batch, min(max_batch, max_mem_bytes // max(1, per)))
        for lo in range(0, len(members), cap):
            chunk = members[lo:lo + cap]
            if len(chunk) < min_batch:
                for idx in chunk:
                    out[idx] = _scalar_run(scenarios[idx],
                                           "batch remainder < min_batch")
                continue
            batch = _LockstepBatch([scenarios[idx] for idx in chunk])
            traces, punted = batch.run()
            for k, idx in enumerate(chunk):
                if k in traces:
                    out[idx] = traces[k]
                else:
                    out[idx] = _scalar_run(scenarios[idx],
                                           f"punt: {punted[k]}")
    if obs_metrics.enabled():
        obs_metrics.inc("batched.scenarios", len(scenarios))
        obs_metrics.inc("batched.lockstep", sum(
            1 for tr in out
            if tr is not None and tr.meta.get("engine") == "batched"))
        for cat, n in fallback_histogram(out).items():
            obs_metrics.inc(f"batched.fallback.{cat}", n)
    return out  # type: ignore[return-value]
