"""The port's dry run (``launch/dryrun.py``) and ``core.distributed.
lower_sharded`` against the reference's.

* A reduced cell of each family (dense, MoE, SSM, hybrid, encoder-decoder:
  train; dense prefill and decode; MoE decode in the resident-weight
  profile) traced on a ``(2, 2)`` fake mesh gives a record with the
  reference's keys, and a dense train cell's per-device flops times the
  mesh size are the one-device step's, plus the work that the rules
  leave replicated (under a fifth).
* The CLI writes the reference's skip record for a long-context cell of a
  quadratic arch, records a failing cell and exits 1, and ``--pdes-core``
  writes both modes' records.
* ``lower_sharded``'s halo bytes a step equal what ``repro``'s
  ``analyze_hlo`` counts on its compiled ``lower_sharded`` on 8 fake
  devices (a ring of 4 shards, 2 ensemble blocks): two
  ``collective-permute``s of one column each way a step in ``exact``
  mode, of K columns a chunk in ``commavoid``.  The all-reduces differ in
  count: XLA combines the per-step GVT ``pmin`` and the chunk's three
  statistics reductions into fewer, wider all-reduces than the port's
  ``torch.distributed`` calls (printed side by side).

Fake process groups are process-global, so each case runs in a
subprocess of its own.
"""
import json
import os
import subprocess
import sys
import textwrap

from torch_parity import SRC

REC_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s", "memory",
            "roofline"}
MEM_KEYS = {"argument_gib", "output_gib", "temp_gib", "alias_gib",
            "peak_gib"}
ROOF_KEYS = {"flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
             "compute_s", "memory_s", "collective_s", "dominant",
             "model_flops", "useful_ratio", "coll_detail"}


def _run(script, timeout=240, env=None):
    out = subprocess.run([sys.executable, "-c", script],
                         env=dict(os.environ, PYTHONPATH=str(SRC),
                                  **(env or {})),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


CELLS_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.train_step import init_train_state, make_train_step

    def reduced(arch):      # the reduced config, one layer group deep
        r = get_config(arch).reduced()
        r = dataclasses.replace(
            r, n_layers=r.hybrid_period or r.group_size,
            encoder_layers=min(r.encoder_layers, 1))
        return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}

    out = {}
    with fake_world(4):
        mesh = make_host_mesh((2, 2))
        for arch, kind in json.loads(CELLS):
            shape = ShapeConfig(kind + "_tiny", 64, 4, kind)
            rec, _ = lower_cell(arch, shape, mesh, overrides=reduced(arch))
            out[arch + ":" + kind] = rec
    # the same dense step on one device, counted
    cfg = get_config("llama3.2-1b").reduced()
    cfg = dataclasses.replace(cfg, **reduced("llama3.2-1b"))
    model, step = make_train_step(cfg, device="cpu")
    state = init_train_state(model)
    batch = make_batch(DataConfig(cfg.vocab_size, 64, 4), 0, device="cpu")
    with CostCounter() as c:
        step(state, batch)
    out["one_device_flops"] = c.cost.flops
    print(json.dumps(out))
""")


def test_reduced_cells_of_every_family():
    cells = [("llama3.2-1b", "train"), ("mixtral-8x7b", "train"),
             ("mamba2-130m", "train"), ("zamba2-2.7b", "train"),
             ("whisper-base", "train"), ("llama3.2-1b", "prefill"),
             ("llama3.2-1b", "decode"), ("mixtral-8x7b", "decode")]
    out = json.loads(_run(CELLS_SCRIPT.replace(
        "json.loads(CELLS)", repr(cells)), timeout=300).splitlines()[-1])
    for arch, kind in cells:
        rec = out[f"{arch}:{kind}"]
        assert set(rec) == REC_KEYS, (arch, kind, set(rec))
        assert set(rec["memory"]) == MEM_KEYS
        assert set(rec["roofline"]) == ROOF_KEYS
        assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
        m, rl = rec["memory"], rec["roofline"]
        assert m["peak_gib"] >= m["argument_gib"] > 0, (arch, kind, m)
        assert rl["flops_per_dev"] > 0 and rl["bytes_per_dev"] > 0
        assert rl["coll_bytes_per_dev"] > 0, (arch, kind)   # it is sharded
        assert rl["dominant"] in ("compute", "memory", "collective")
    # one dense train step split four ways: every product is there, about
    # a quarter of it on each rank; the surplus is the backward of the MLP
    # down-projection, whose stacked weight the reference's rule for a 3-D
    # ``wo`` leaves whole over TP, so both TP ranks compute it
    per_dev = out["llama3.2-1b:train"]["roofline"]["flops_per_dev"]
    ratio = 4 * per_dev / out["one_device_flops"]
    assert 1.0 <= ratio < 1.2, (per_dev, out["one_device_flops"])


CLI_SCRIPT = textwrap.dedent("""
    import json, pathlib, sys
    from repro_torch.launch import dryrun
    out = pathlib.Path(sys.argv[1])
    try:
        dryrun.main(["--cells", "llama3.2-1b:long_500k,no-such-arch:train_4k",
                     "--out", str(out)])
    except SystemExit as e:
        print("exit", e.code)
    dryrun.main(["--pdes-core", "--out", str(out)])
""")


def test_cli_skip_fail_and_pdes_core(tmp_path):
    out = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "exit 1" in out.stdout, out.stdout
    skip = json.loads((tmp_path / "llama3.2-1b__long_500k__single.json")
                      .read_text())
    assert skip == {"arch": "llama3.2-1b", "shape": "long_500k",
                    "mesh": "single", "status": "skipped",
                    "reason": "sub-quadratic rule (DESIGN.md §6)"}
    fail = json.loads((tmp_path / "no-such-arch__train_4k__single.json")
                      .read_text())
    assert fail["status"] == "fail" and "KeyError" in fail["error"]
    for mode in ("exact", "commavoid"):
        rec = json.loads((tmp_path / f"pdes-core__{mode}__single.json")
                         .read_text())
        assert set(rec) == {"arch", "mode", "mesh", "status", "lower_s", "L",
                            "trials", "steps", "flops_per_dev",
                            "bytes_per_dev", "coll_bytes_per_step",
                            "coll_msgs_per_step", "collectives",
                            "memory_temp_gib"}
        assert (rec["L"], rec["trials"], rec["steps"]) == (1 << 20, 512, 64)
        # one shard: 32 rows of 65,536 PEs; each way a halo of one fp32
        # column a step (exact), or of K = 16 columns a chunk of 16 steps
        assert rec["collectives"]["collective-permute"] / 64 == 2 * 32 * 4


PDES_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    from repro.compat import make_mesh
    from repro.core.distributed import DistConfig, lower_sharded
    from repro.core.horizon import PDESConfig
    from repro.launch.hlo_cost import analyze_hlo
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for mode in ("exact", "commavoid"):
        cost = analyze_hlo(lower_sharded(
            PDESConfig(L=256, n_v=100, delta=100.0), mesh, n_trials=8,
            n_steps=32, dist=DistConfig(mode=mode, k_chunk=16)
        ).compile().as_text())
        out[mode] = {"coll": cost.coll, "msgs": cost.coll_msgs}
    print(json.dumps(out))
""")

PDES_PORT = textwrap.dedent("""
    import json
    from repro_torch.core.distributed import DistConfig, lower_sharded
    from repro_torch.core.horizon import PDESConfig
    from repro_torch.core.mesh import ProcessMesh
    from repro_torch.launch.mesh import fake_world
    out = {}
    with fake_world(8):
        for mode in ("exact", "commavoid"):
            cost, mem = lower_sharded(
                PDESConfig(L=256, n_v=100, delta=100.0),
                ProcessMesh.abstract((2, 4), ("data", "model")), n_trials=8,
                n_steps=32, dist=DistConfig(mode=mode, k_chunk=16))
            out[mode] = {"coll": cost.coll, "msgs": cost.coll_msgs,
                         "mem": mem}
    print(json.dumps(out))
""")


def test_lower_sharded_halo_bytes_equal_the_reference():
    jax_side = subprocess.Popen(
        [sys.executable, "-c", PDES_JAX], text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"))
    try:
        ours = json.loads(_run(PDES_PORT).splitlines()[-1])
        out, err = jax_side.communicate(timeout=240)
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.wait()
    assert jax_side.returncode == 0, err[-4000:]
    ref = json.loads(out.splitlines()[-1])
    steps = 32
    for mode in ("exact", "commavoid"):
        r, o = ref[mode], ours[mode]
        assert o["coll"]["collective-permute"] / steps == \
            r["coll"]["collective-permute"] / steps, (mode, o, r)
        print(f"{mode}: all-reduce bytes/step port "
              f"{o['coll']['all-reduce'] / steps:g} reference "
              f"{r['coll']['all-reduce'] / steps:g}; messages/step port "
              f"{o['msgs'] / steps:g} reference {r['msgs'] / steps:g}")
        # the shard's tau (4 rows x 64 PEs) and its Kahan pair, fp32
        assert o["mem"]["argument_bytes"] == (4 * 64 + 2 * 4) * 4
