"""GPU adaptation of the paper's technique: predict multi-node step time by
replaying a fine-grained op DAG under a link-sharing model.

The port's counterpart of ``repro/core/tpu_adapter.py``.  The DAG is the
reference's, op for op; only the resources and their constants change:

  PS downlink/uplink   ->  NVLink per direction (all-gather ``nvlink_ag``,
                           reduce-scatter ``nvlink_rs``)
  PS update phase      ->  optimizer segment on the CUDA cores (``cuda``)
  HTTP/2 WIN chunking  ->  chunked collectives interleaving with compute
  worker compute       ->  per-layer tensor-core segments (``tensor``)
  cross-node           ->  all-reduce of (possibly compressed) grads over
                           the inter-node network (``net``)

A :class:`MeshFactors` here is ``data`` GPUs of one node (FSDP over
NVLink) times ``model`` (tensor parallel) times ``pods`` nodes.  The
reference runs its ``mxu`` and ``vpu`` segments concurrently; on a GPU the
tensor-core and CUDA-core work share the SMs.  The port keeps the
reference's semantics, so it predicts what the reference predicts under
other constants (:class:`GpuSpec`).

Calibration hook: :func:`calibrate` rescales the DAG's tensor-core
segments so the summed compute matches the FLOPs of the real step,
counted by ``flop_count.count_step_flops`` (profile once, predict many,
as the paper profiles one worker).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.config import ModelConfig
from .events import COMPUTE, LINK, Op, ResourceSpec, StepTemplate
from .flop_count import H100_SXM, GpuSpec
from .simulator import SimConfig, Simulation


@dataclass(frozen=True)
class MeshFactors:
    data: int = 8              # GPUs of a node (FSDP over NVLink)
    model: int = 1
    pods: int = 1              # nodes
    mfu: float = 0.5           # sustained fraction of peak on tensor cores

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pods


def gpu_resources(num_pods: int = 1,
                  spec: GpuSpec = H100_SXM) -> Dict[str, ResourceSpec]:
    res = {
        "tensor": ResourceSpec("tensor", COMPUTE),
        "cuda": ResourceSpec("cuda", COMPUTE),
        # NVLink modelled per direction like the paper's downlink/uplink
        "nvlink_ag": ResourceSpec("nvlink_ag", LINK, spec.link_bw),
        "nvlink_rs": ResourceSpec("nvlink_rs", LINK, spec.link_bw),
    }
    if num_pods > 1:
        res["net"] = ResourceSpec("net", LINK, spec.net_bw)
    return res


def _layer_param_bytes(cfg: ModelConfig) -> List[Tuple[str, float, float]]:
    """Per layer: (kind, param bytes, active fraction)."""
    out = []
    d, f = cfg.d_model, cfg.d_ff
    bytes_per = 2.0  # bf16
    for li in range(cfg.n_layers):
        kind = cfg.pattern[li % len(cfg.pattern)]
        attn = (d * cfg.n_heads * cfg.head_dim * 2
                + d * cfg.n_kv * cfg.head_dim * 2)
        if kind == "moe":
            m = cfg.moe
            fe = cfg.d_expert_eff
            routed = m.num_experts * 3 * d * fe
            shared = m.num_shared * 3 * d * fe + (
                3 * d * cfg.dense_residual_ff if cfg.dense_residual_ff else 0)
            params = attn + routed + shared
            active = (attn + m.top_k * 3 * d * fe + shared) / params
        elif kind in ("slstm", "mlstm"):
            params = d * d * 6  # projections + gates (approx)
            active = 1.0
        elif kind == "rglru":
            r = cfg.rnn_width
            params = d * r * 2 + r * r * 2 + r * d + 3 * d * f
            active = 1.0
        else:
            glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
            params = attn + glu * d * f
            if kind in ("xattn", "encdec"):
                params += attn
            active = 1.0
        out.append((kind, params * bytes_per, active))
    return out


def build_step_dag(cfg: ModelConfig, mesh: MeshFactors, tokens_global: int,
                   chunk_layers: int = 1,
                   compressed_dcn: float = 1.0,
                   spec: GpuSpec = H100_SXM) -> StepTemplate:
    """One training step as an op DAG (per-device quantities).

    fwd_i needs param all-gather_i (FSDP); bwd_i (reverse order) needs the
    same gather; grad reduce-scatter_i is eligible right after bwd_i — the
    exact structure of the paper's Fig. 6, with {downlink, uplink} replaced
    by {nvlink_ag, nvlink_rs}.  With ``pods > 1`` an inter-node all-reduce
    per layer follows the reduce-scatter (optionally compressed).
    ``chunk_layers`` is kept for the reference's signature and unused, as
    there.
    """
    layers = _layer_param_bytes(cfg)
    tokens_dev = tokens_global / (mesh.data * mesh.pods)
    flops_rate = spec.peak_flops * mesh.mfu
    ops: List[Op] = []
    idx: Dict[Tuple[str, int], int] = {}

    def add(op: Op, key) -> int:
        ops.append(op)
        idx[key] = len(ops) - 1
        return len(ops) - 1

    L = len(layers)
    for i, (kind, pbytes, active) in enumerate(layers):
        # all-gather of the layer's params over the fsdp axis (per device
        # wire bytes: (n-1)/n of the tp-sharded full layer)
        n = mesh.data
        ag_bytes = (pbytes / mesh.model) * (n - 1) / n
        add(Op(name=f"ag/{i}", res="nvlink_ag", size=ag_bytes,
               tags={"layer": i}), ("ag", i))
        # forward compute: 2 * active_params * tokens FLOPs on this device
        fwd_flops = 2.0 * (pbytes / 2.0) * active * tokens_dev / mesh.model
        deps = [idx[("ag", i)]]
        if i > 0:
            deps.append(idx[("fwd", i - 1)])
        add(Op(name=f"fwd/{i}", res="tensor",
               duration=fwd_flops / flops_rate,
               deps=tuple(deps), tags={"layer": i}), ("fwd", i))
    for i in range(L - 1, -1, -1):
        kind, pbytes, active = layers[i]
        bwd_flops = 4.0 * (pbytes / 2.0) * active * \
            (tokens_global / (mesh.data * mesh.pods)) / mesh.model
        deps = [idx[("fwd", L - 1)]] if i == L - 1 else [idx[("bwd", i + 1)]]
        # re-gather for bwd (remat path) — eligible in parallel with bwd i+1
        ag2 = add(Op(name=f"ag2/{i}", res="nvlink_ag",
                     size=(pbytes / mesh.model) * (mesh.data - 1) / mesh.data,
                     deps=(idx[("fwd", L - 1)],) if i == L - 1 else
                     (idx[("bwd", i + 1)],),
                     tags={"layer": i}), ("ag2", i))
        add(Op(name=f"bwd/{i}", res="tensor",
               duration=bwd_flops / (spec.peak_flops * mesh.mfu),
               deps=tuple(deps) + (ag2,), tags={"layer": i}), ("bwd", i))
        n = mesh.data
        rs_bytes = (pbytes / mesh.model) * (n - 1)  # unscattered input
        add(Op(name=f"rs/{i}", res="nvlink_rs", size=rs_bytes / n * n,
               deps=(idx[("bwd", i)],), tags={"layer": i}), ("rs", i))
        if mesh.pods > 1:
            dcn_bytes = (pbytes / mesh.chips) * 2 * compressed_dcn
            add(Op(name=f"dcn/{i}", res="net", size=dcn_bytes,
                   deps=(idx[("rs", i)],), tags={"layer": i}), ("dcn", i))
        # optimizer segment (the paper's "update phase", on the CUDA cores)
        upd_dep = ("dcn", i) if mesh.pods > 1 else ("rs", i)
        add(Op(name=f"opt/{i}", res="cuda",
               duration=3.0 * (pbytes / mesh.chips) / spec.hbm_bw,
               deps=(idx[upd_dep],), tags={"layer": i}), ("opt", i))
    return StepTemplate(ops=ops, meta={"arch": cfg.name,
                                       "tokens": tokens_global,
                                       "chips": mesh.chips})


def calibrate(dag: StepTemplate, flops_per_device: float,
              mfu: float = 0.5, spec: GpuSpec = H100_SXM) -> StepTemplate:
    """Rescale tensor-core segments so total compute matches the counted
    step."""
    total = sum(op.duration for op in dag.ops if op.res == "tensor")
    target = flops_per_device / (spec.peak_flops * mfu)
    if total <= 0:
        return dag
    scale = target / total
    ops = [Op(name=o.name, res=o.res, size=o.size,
              duration=o.duration * (scale if o.res == "tensor" else 1.0),
              deps=o.deps, priority=o.priority, tags=dict(o.tags))
           for o in dag.ops]
    return StepTemplate(ops=ops, meta=dict(dag.meta))


def predict_step_time(dag: StepTemplate, num_pods: int = 1,
                      straggler_factor: float = 1.0,
                      link_policy: str = "fifo",
                      win_bytes: float = 0.0,
                      seed: int = 0,
                      spec: GpuSpec = H100_SXM) -> float:
    """DES-predicted step time (seconds).

    ``straggler_factor > 1`` slows one simulated worker's compute (the
    paper's heterogeneity what-if); ``win_bytes > 0`` switches the link
    scheduler to the paper's WIN-chunked multiplexing model (chunked
    collectives interleaving with compute).
    """
    steps = [dag]
    if straggler_factor != 1.0:
        slow_ops = [Op(name=o.name, res=o.res, size=o.size,
                       duration=o.duration * straggler_factor, deps=o.deps,
                       priority=o.priority, tags=dict(o.tags))
                    for o in dag.ops]
        steps = [StepTemplate(ops=slow_ops, meta=dict(dag.meta))]
    cfg = SimConfig(
        resources=gpu_resources(num_pods, spec),
        link_policy=("http2" if win_bytes > 0 else link_policy),
        win=win_bytes or 28e6,
        steps_per_worker=6,
        warmup_steps=2,
        seed=seed,
    )
    sim = Simulation(cfg)
    trace = sim.run(steps, num_workers=1, sample=False)
    comps = sorted(t for _w, _s, t in trace.step_completions)
    if len(comps) < 3:
        return comps[-1] if comps else float("inf")
    # steady-state per-step time after the first step
    return (comps[-1] - comps[1]) / (len(comps) - 2)
