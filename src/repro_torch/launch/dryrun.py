"""Multi-node dry run: one step of every (arch x shape x mesh) cell traced
on a fake process group (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with GSPMD on 256 or 512
fake XLA devices.  The port keeps the purpose with PyTorch's own means:
a fake process group of the mesh's size (``launch.mesh.fake_world``), a
``DeviceMesh`` on it, the state and batch as DTensors placed by the
sharding rules, and one step of the cell's kind run by rank 0 under
``FakeTensorMode`` (no storage) inside ``launch.cost.CostCounter``, which
counts the rank's flops, bytes, collectives and live memory.  Success
shows the rules are coherent (every op has its placements); the memory
shows whether a rank's share fits; the cost feeds the H100 roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single --out results/torch/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --pdes-core

The PDES core itself is dry-runnable with ``--pdes-core`` (a ring of 2^20
PEs x 512 trials): one rank's shard of the sharded runtime under the
counter, halo traffic included.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

from ..configs import ARCH_IDS, cell_is_runnable, get_config, get_shape
from ..configs.base import SHAPES, ShapeConfig
from ..distributed.sharding import Parallelism, mesh_sizes
from . import roofline as RL
from .cost import CostCounter
from .mesh import fake_world, make_production_mesh, production_shape
from .specs import abstract_cache, abstract_params, abstract_state, \
    batch_specs

GIB = 2 ** 30


def _parallelism(mesh, joint_batch: bool = False,
                 serve: bool = False) -> Parallelism:
    multi = "pod" in mesh.mesh_dim_names
    return Parallelism(
        mesh=mesh,
        dp_axes=("pod", "data") if multi else ("data",),
        fsdp_axis=None if serve else "data",
        tp_axis="model",
        joint_batch=joint_batch,
        serve=serve,
    )


def _storages(tree) -> dict:
    """``{id of storage: bytes}`` of the tensors (DTensors: their local
    shards) of ``tree``."""
    from .cost import _tensors
    out = {}
    for t in _tensors(tree):
        st = getattr(t, "_local_tensor", t).untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def lower_cell(arch: str, shape, mesh, *, overrides: dict | None = None,
               joint_batch: bool | None = None, scale_loops: bool = True):
    """Trace one step of ``arch`` at ``shape`` (a name or a
    ``ShapeConfig``) on ``mesh`` (a ``DeviceMesh`` over a fake group):
    returns ``(record, Cost)``.  The model's loops are counted once each
    and scaled by their trip counts (``launch.cost.scan``);
    ``scale_loops=False`` traces every iteration."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..optim.adamw import AdamWConfig
    from ..train.train_step import (make_decode_step, make_prefill_step,
                                    make_train_step, shard_batch,
                                    shard_cache)
    shape_cfg = shape if isinstance(shape, ShapeConfig) else get_shape(shape)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    par = _parallelism(mesh, bool(joint_batch),
                       serve=(shape_cfg.kind == "decode"))
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape_cfg.kind == "train":
            model, step = make_train_step(cfg, par, AdamWConfig(),
                                          device="cpu")
            state = abstract_state(model, cfg)
            args = (state, shard_batch(batch_specs(cfg, shape_cfg), par))
            aliased = _storages(state)        # updated in place
        elif shape_cfg.kind == "prefill":
            model, step = make_prefill_step(cfg, par, device="cpu")
            args = (shard_batch(batch_specs(cfg, shape_cfg), par),)
            aliased = {}
        else:
            model, step = make_decode_step(cfg, par, device="cpu")
            cache = shard_cache(abstract_cache(model, cfg, shape_cfg), par)
            tokens = batch_specs(cfg, shape_cfg)["tokens"]
            args = (cache, tokens, shape_cfg.seq_len - 1)
            aliased = _storages(cache)        # written in place
        with CostCounter(scale_loops=scale_loops) as counter:
            arg_bytes = counter.track((args, abstract_params(model, cfg)))
            out = step(*args)
            out_st = _storages(out)
    out_bytes = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in aliased)
    temp = max(counter.peak_bytes - arg_bytes - (out_bytes - alias), 0)
    sizes = mesh_sizes(mesh)
    rec = {
        "arch": arch, "shape": shape_cfg.name,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "n_devices": mesh.size(),
        "lower_s": round(time.time() - t0, 1),
        "memory": {
            "argument_gib": arg_bytes / GIB,
            "output_gib": out_bytes / GIB,
            "temp_gib": temp / GIB,
            "alias_gib": alias / GIB,
            "peak_gib": (arg_bytes + out_bytes + temp - alias) / GIB,
        },
    }
    rl = RL.analyze(counter.cost, n_devices=mesh.size(),
                    model_flops=RL.model_flops_for(cfg, shape_cfg))
    rec["roofline"] = rl.to_dict()
    return rec, counter.cost


def run_cells(cells, meshes, out_dir: pathlib.Path, overrides=None):
    """Dry-run ``cells`` (``(arch, shape)``) on each named mesh, one fake
    group a mesh; a record per cell in ``out_dir``.  Returns the number
    that failed (a failure is recorded and the run goes on)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = fail = 0
    for mesh_name in meshes:
        multi = mesh_name == "multi"
        with fake_world(math.prod(production_shape(multi)[0])):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape_name in cells:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                path = out_dir / f"{tag}.json"
                if not cell_is_runnable(arch, shape_name):
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": mesh_name, "status": "skipped",
                         "reason": "sub-quadratic rule (DESIGN.md §6)"},
                        indent=1))
                    print(f"[skip] {tag}")
                    continue
                try:
                    rec, _ = lower_cell(arch, shape_name, mesh,
                                        overrides=overrides)
                    rec["status"] = "ok"
                    ok += 1
                    print(f"[ok]   {tag}  lower={rec['lower_s']}s "
                          f"peak={rec['memory']['peak_gib']:.3f}GiB "
                          f"dom={rec['roofline']['dominant']}")
                except Exception as e:  # noqa: BLE001 - record and go on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    fail += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: "
                          f"{str(e)[:200]}")
                path.write_text(json.dumps(rec, indent=1))
    print(f"done: {ok} ok, {fail} failed")
    return fail


def pdes_core_record(mode: str, mesh_name: str, *, L: int = 1 << 20,
                     trials: int = 512, steps: int = 64, device="cpu"):
    """One rank's shard of the sharded PDES on the named production mesh
    (a fake group of its size must be the default group): the
    reference's record keys.  With ``device="cpu"`` the shard runs on
    fake tensors; on ``"cuda"`` for real, through B2."""
    from ..core.distributed import DistConfig, lower_sharded
    from ..core.horizon import PDESConfig
    from ..core.mesh import ProcessMesh
    shape, axes = production_shape(multi_pod=(mesh_name == "multi"))
    multi = mesh_name == "multi"
    cfg = PDESConfig(L=L, n_v=100, delta=100.0)
    dist_cfg = DistConfig(ens_axes=("pod", "data") if multi else ("data",),
                          ring_axis="model", mode=mode, k_chunk=16)
    t0 = time.time()
    cost, mem = lower_sharded(cfg, ProcessMesh.abstract(shape, axes),
                              n_trials=trials, n_steps=steps, dist=dist_cfg,
                              device=device)
    return {
        "arch": "pdes-core", "mode": mode, "mesh": mesh_name,
        "status": "ok", "lower_s": round(time.time() - t0, 1),
        "L": cfg.L, "trials": trials, "steps": steps,
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.bytes,
        "coll_bytes_per_step": cost.coll_bytes / steps,
        "coll_msgs_per_step": cost.coll_msgs / steps,
        "collectives": dict(cost.coll),
        "memory_temp_gib": mem["temp_bytes"] / GIB,
    }


def pdes_core_cell(mesh_name: str, out_dir: pathlib.Path):
    """Dry-run the paper's own workload on the production mesh, both
    modes; a record each in ``out_dir``."""
    with fake_world(math.prod(production_shape(mesh_name == "multi")[0])):
        for mode in ("exact", "commavoid"):
            rec = pdes_core_record(mode, mesh_name)
            (out_dir / f"pdes-core__{mode}__{mesh_name}.json").write_text(
                json.dumps(rec, indent=1))
            print(f"[ok]   pdes-core {mode} {mesh_name} "
                  f"coll/step={rec['coll_bytes_per_step']:.3g}B "
                  f"msgs/step={rec['coll_msgs_per_step']:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cells", default=None, help="'all' or 'arch:shape,...'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--pdes-core", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.pdes_core:
        for m in meshes:
            pdes_core_cell(m, out)
        return
    if args.cells == "all":
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(args.arch, args.shape)]
    raise SystemExit(1 if run_cells(cells, meshes, out) else 0)


if __name__ == "__main__":
    main()
