"""Multi-pod dry-run: lower every (arch x shape x mesh) cell on the meta device.

The JAX package's ``launch/dryrun.py`` on the port.  A process group of 256
fake ranks (512 with ``--multi-pod``) comes up first, the counterpart of
the JAX package's 512 placeholder host devices:
``init_process_group("fake", ...)`` gives shape-only ranks in one process.
Per cell this driver:

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod),
  2. resolves the sharding plan (train or serve mode per shape kind),
  3. places the step's arguments as DTensors of meta shards at the plan's
     layouts and lowers the step (:func:`repro_torch.core.lowering.lower`:
     one eager run on meta tensors, the local ops of one rank counted),
  4. records ``memory_analysis()`` (residency) and ``cost_analysis()``,
  5. (single-pod) lowers two layer probes, at one and two periods of
     layers, and extrapolates them to the model's depth (the roofline
     terms; see ``repro_torch.roofline.analysis``),
  6. appends the cell's row to a JSON results file (the JAX package's
     layout; ``python -m repro_torch.roofline.report`` renders it).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/torch/dryrun.json]

Nothing runs on a card and nothing is allocated: a full-width cell costs
host CPU time only, mostly DTensor's per-op dispatch (seconds to minutes a
cell; a cell past ``CELL_LIMIT_S`` is stopped and its row says so).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.configs import ARCHS, cell_is_runnable, get_config, step_inputs
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.core import lowering
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis as ra
from repro_torch.train import steps as st

#: the port's results directory (the JAX package writes results/dryrun.json)
DEFAULT_OUT = "results/torch/dryrun.json"
#: host seconds a cell's lowering (and then its two probes) may take
#: before it is stopped; its row records the ``TimeoutError``
CELL_LIMIT_S = 1800.0


def init_fake_group(world: int) -> None:
    """A process group of ``world`` shape-only ranks in this process (this
    process is rank 0); a group that is up already must have that size."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the dry-run needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# ---------------------------------------------------------------------------
# per-cell lowering
# ---------------------------------------------------------------------------

def _shardings(mesh, specs, tree):
    """``tree`` (meta tensors) as DTensors at ``specs`` on ``mesh``; each
    fake rank holds only its own meta shard (the JAX package's
    ``NamedSharding`` tree, applied)."""
    return sh.distribute_tree(tree, mesh, specs, src_data_rank=None)


def _dryrun_cfg(cfg: ModelConfig) -> ModelConfig:
    """Production overrides for at-scale lowering: chunked attention keeps
    the score working set bounded (the JAX package's choice, which keeps
    its Pallas kernel off the CPU; the dry-run runs no kernel either)."""
    return dataclasses.replace(cfg, attn_impl="chunked")


def _probe_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """A probe: ``n_layers`` unrolled layers, the plain attention, MoE
    routing in one group.  The port's eager loops (the mLSTM chunks, the
    sLSTM time steps) run whole, so every product is counted: no residual
    is added back (``run_cell``)."""
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        use_scan=False,
        attn_impl="xla",
        moe_group_size=1 << 30,
    )


def _period(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return len(cfg.block_pattern)
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def _plan(cfg: ModelConfig, mode: str, mesh, plan_overrides: Optional[dict]):
    overrides = dict(plan_overrides or {})
    if mode == "serve" and "serve_expert_fsdp" not in overrides:
        # expert FSDP only when the experts cannot fit pure TP: mixtral fits
        # (5.9 GiB) -> off; qwen3 (29 GiB) -> on
        model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        overrides["serve_expert_fsdp"] = cfg.param_count()[0] * 2 / model_size > 10 * 2**30
    return sh.make_plan(mesh, mode=mode, **overrides)


def lower_step(
    cfg: ModelConfig,
    seq: int,
    batch: int,
    kind: str,
    mesh=None,
    *,
    donate: bool = True,
    plan_overrides: Optional[dict] = None,
    inputs: Any = None,
) -> lowering.Compiled:
    """Lower one step of ``cfg`` as given: ``kind`` ``"train"`` (params,
    AdamW state and batch; the state donated), ``"prefill"`` or
    ``"decode"`` (the caches donated) at ``seq`` x global ``batch``.
    ``mesh=None`` lowers the one-device program (no plan, no Sharder).
    ``inputs``: the batch the step takes (its shapes and dtypes; default
    :func:`~repro_torch.configs.step_inputs`, the JAX package's int32
    specs)."""
    mode = "train" if kind == "train" else "serve"
    plan = _plan(cfg, mode, mesh, plan_overrides) if mesh is not None else None
    use_sharder = plan is not None and plan.use_sharder
    batch_tree = (step_inputs(cfg, seq, batch, kind) if inputs is None
                  else lowering.meta_like(inputs))
    if plan is not None:
        batch_tree = _shardings(mesh, sh.batch_specs(plan, batch_tree, batch), batch_tree)

    if kind == "train":
        params, opt_state = st.abstract_train_state(cfg)
        sharder = None
        if plan is not None:
            p_specs = sh.param_specs(plan, params)
            o_specs = sh.opt_state_specs(plan, p_specs, params)
            sharder = (sh.make_sharder(plan, params, batch, seq_len=seq,
                                       seq_shard=not plan.pure_dp) if use_sharder else None)
            params = _shardings(mesh, p_specs, params)
            opt_state = _shardings(mesh, o_specs, opt_state)
        fn = st.make_train_step(cfg, AdamWConfig(), mesh, sharder)  # its values move no count
        lowered = lowering.lower(fn, params, opt_state, batch_tree,
                                 donate_argnums=(0, 1) if donate else ())
    elif kind == "prefill":
        params = st.abstract_params(cfg)
        sharder = None
        if plan is not None:
            sharder = sh.make_sharder(plan, params, batch) if use_sharder else None
            params = _shardings(mesh, sh.param_specs(plan, params), params)
        fn = st.make_prefill_step(cfg, batch, seq, mesh, sharder)
        lowered = lowering.lower(fn, params, batch_tree)
    else:  # decode
        params = st.abstract_params(cfg)
        caches = st.abstract_caches(cfg, batch, seq)
        sharder = None
        if plan is not None:
            sharder = sh.make_sharder(plan, params, batch) if use_sharder else None
            c_specs = sh.cache_specs_tree(plan, caches, batch)
            params = _shardings(mesh, sh.param_specs(plan, params), params)
            caches = _shardings(mesh, c_specs, caches)
        pos = torch.empty((), dtype=torch.int32, device="meta")  # a scalar: every rank's
        fn = st.make_decode_step(cfg, mesh, sharder)
        lowered = lowering.lower(fn, params, caches, batch_tree, pos,
                                 donate_argnums=(1,) if donate else ())
    return lowered.compile()


def lower_cell(
    cfg: ModelConfig,
    shape: str,
    mesh,
    *,
    probe_layers: Optional[int] = None,
    donate: bool = True,
    cfg_overrides: Optional[dict] = None,
    plan_overrides: Optional[dict] = None,
):
    """Lower one named cell.  Returns (compiled, step_kind, n_tokens)."""
    seq, batch, step_kind = SHAPES[shape]
    cfg = _probe_cfg(cfg, probe_layers) if probe_layers is not None else _dryrun_cfg(cfg)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    compiled = lower_step(cfg, seq, batch, step_kind, mesh, donate=donate,
                          plan_overrides=plan_overrides)
    return compiled, step_kind, seq * batch


def _mem_fields(compiled) -> dict[str, float]:
    m = compiled.memory_analysis()
    keys = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    out = {k: float(getattr(m, k, 0) or 0) for k in keys}
    out["per_device_total_gib"] = (
        out["argument_size_in_bytes"]
        + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"]
        - out["alias_size_in_bytes"]
    ) / 2**30
    return out


def run_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    probes: bool = True,
    verbose: bool = True,
    cfg_overrides: Optional[dict] = None,
    plan_overrides: Optional[dict] = None,
) -> dict[str, Any]:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, why = cell_is_runnable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict[str, Any] = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "runnable": ok,
    }
    if not ok:
        rec["skip_reason"] = why
        if verbose:
            print(f"[skip] {arch} x {shape}: {why}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_dev = mesh.size()
    seq, batch, step_kind = SHAPES[shape]
    t0 = time.time()
    try:
        with lowering.time_limit(CELL_LIMIT_S):
            compiled, step_kind, _ = lower_cell(
                cfg, shape, mesh,
                cfg_overrides=cfg_overrides, plan_overrides=plan_overrides,
            )
    except Exception as e:  # noqa: BLE001 — recorded, the report shows it
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape} [{mesh_name}]: {rec['error'][:200]}")
        return rec

    rec["ok"] = True
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["step_kind"] = step_kind
    rec["memory"] = _mem_fields(compiled)
    rec["cost_raw"] = ra.cost_terms(compiled)
    rec["coll_raw"] = ra.collective_bytes_from_hlo(compiled.as_text())
    del compiled

    if probes and not multi_pod:
        p = _period(cfg)
        L = cfg.n_layers
        try:
            with lowering.time_limit(CELL_LIMIT_S):
                c1, _, _ = lower_cell(cfg, shape, mesh, probe_layers=p, donate=False,
                                      cfg_overrides=cfg_overrides, plan_overrides=plan_overrides)
                t1 = ra.cost_terms(c1)
                x1 = ra.collective_bytes_from_hlo(c1.as_text())
                del c1
                c2, _, _ = lower_cell(cfg, shape, mesh, probe_layers=2 * p, donate=False,
                                      cfg_overrides=cfg_overrides, plan_overrides=plan_overrides)
                t2 = ra.cost_terms(c2)
                x2 = ra.collective_bytes_from_hlo(c2.as_text())
                del c2
            periods = L // p
            scale = lambda a, b: a + (periods - 1) * (b - a)  # noqa: E731
            flops = scale(t1["flops"], t2["flops"])
            bytes_ = scale(t1["bytes"], t2["bytes"])
            coll = {k: int(scale(x1[k], x2[k])) for k in x1}
            res = ra.RooflineResult(
                arch=arch,
                shape=shape,
                mesh=mesh_name,
                step_kind=step_kind,
                n_devices=n_dev,
                hlo_flops=flops,
                hlo_bytes=bytes_,
                coll_bytes_by_class=coll,
                coll_bytes_weighted=ra.weighted_collective_bytes(coll),
                # the probes run every inner loop whole (the mLSTM chunks,
                # the sLSTM time steps): nothing is left to add back, where
                # the JAX package adds residual_inner_scan_flops
                residual_flops=0.0,
                model_flops_global=ra.model_flops(cfg, step_kind, seq, batch),
                analytic_bytes=ra.analytic_hbm_bytes(
                    cfg,
                    step_kind,
                    seq,
                    batch,
                    n_devices=n_dev,
                    tp_degree=1 if (plan_overrides or {}).get("pure_dp") else None,
                ),
            )
            rec["probe"] = {
                "flops": flops,
                "bytes": bytes_,
                "coll": coll,
                "coll_weighted": res.coll_bytes_weighted,
                "residual_flops": res.residual_flops,
                "model_flops_global": res.model_flops_global,
                "analytic_bytes": res.analytic_bytes,
            }
            rec["roofline"] = res.terms()
            if verbose:
                print(ra.roofline_report(res))
        except Exception as e:  # noqa: BLE001
            rec["probe_error"] = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"[probe-fail] {arch} x {shape}: {rec['probe_error'][:200]}")

    if verbose:
        mem = rec["memory"]
        print(
            f"[ok] {arch} x {shape} [{mesh_name}] compile={rec['compile_s']}s "
            f"mem/dev={mem['per_device_total_gib']:.2f} GiB"
        )
    return rec


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _load(path: Path) -> list[dict]:
    if path.exists():
        return json.loads(path.read_text())
    return []


def _save(path: Path, rows: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(rows, indent=1))
    tmp.rename(path)


def _parse_kv(items: list[str]) -> dict:
    out = {}
    for it in items:
        k, v = it.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true", help="re-run completed cells")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ModelConfig override, e.g. remat=none")
    ap.add_argument("--plan-set", action="append", default=[], metavar="K=V",
                    help="ShardingPlan override, e.g. attn_indivisible=replicate")
    args = ap.parse_args(argv)
    # the fake ranks come up before any cell is built (the JAX package sets
    # its placeholder device count before JAX starts)
    init_fake_group(512 if args.multi_pod else 256)

    cfg_overrides = _parse_kv(args.set)
    plan_overrides = _parse_kv(args.plan_set)

    out = Path(args.out)
    rows = _load(out)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in rows
            if r.get("ok") or not r.get("runnable", True)}
    mesh_name = "2x16x16" if args.multi_pod else "16x16"

    cells = (
        [(a, s) for a in ARCHS for s in SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    n_fail = 0
    for arch, shape in cells:
        if not arch or not shape:
            ap.error("--arch/--shape required unless --all")
        if not args.force and (arch, shape, mesh_name) in done:
            print(f"[cached] {arch} x {shape} [{mesh_name}]")
            continue
        rec = run_cell(
            arch, shape, multi_pod=args.multi_pod, probes=not args.no_probes,
            cfg_overrides=cfg_overrides or None, plan_overrides=plan_overrides or None,
        )
        rows = [
            r for r in rows
            if not (r["arch"] == arch and r["shape"] == shape and r["mesh"] == mesh_name)
        ] + [rec]
        _save(out, rows)
        if rec.get("runnable") and not rec.get("ok"):
            n_fail += 1
        gc.collect()
    print(f"done: {len(cells)} cells, {n_fail} failures -> {out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
