"""The port's linter rules on their seeded violations, the ``dtype-drift``
exemptions, the ptxas-log parser and the kernels' launch plans.

Every rule is proven live by a fixture (``repro_torch.analysis.fixtures``,
the reference's six in torch): each plants exactly one protocol violation,
its rule must report it with provenance, and the other rules must stay
quiet (``tests/test_analysis.py`` asks the same of the reference).
"""
import contextlib
import pathlib
import re

import pytest
import torch

from repro_torch.analysis import analyze_probe
from repro_torch.analysis.fixtures import EXTRA, FIXTURES
from repro_torch.analysis.probes import iter_probes
from repro_torch.analysis.rules import dtype_drift
from repro_torch.kernels import (_build, pdes_multistep, pdes_step, threefry,
                                 tiling)
from repro_torch.kernels.tiling import SMEM_PER_BLOCK
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CSRC = pathlib.Path(_build.CSRC)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_fires_expected_rule(name):
    probe, expected_rule = FIXTURES[name]()
    findings = analyze_probe(probe)
    fired = {f.rule for f in findings}
    assert expected_rule in fired, (
        f"fixture {name!r} should trip {expected_rule!r}; fired: "
        f"{sorted(fired)}")
    hits = [f for f in findings if f.rule == expected_rule]
    # findings carry context + provenance, not just a verdict
    assert all(f.backend == probe.backend and f.probe == probe.name
               for f in hits)
    assert any(f.op or f.path for f in hits), hits


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_clean_rules_stay_quiet(name):
    """A planted violation must not cascade into unrelated rules."""
    probe, expected_rule = FIXTURES[name]()
    fired = {f.rule for f in analyze_probe(probe)}
    assert fired == {expected_rule}, sorted(fired)


def test_dtype_drift_exemptions():
    """tau widened to fp64 fires; C1's fp64 decode and the int64 word
    carrier, which every clean probe holds, do not."""
    probe, rule = EXTRA["f64_tau"]()
    findings = analyze_probe(probe)
    assert {f.rule for f in findings} == {rule}
    assert any("tau output dtype float64" in f.message for f in findings)
    # the declared site is the decode's fp64 log
    file, line = dtype_drift.FP64_SITE.split(":")
    src = (pathlib.Path(pdes_step.__file__).parents[1] / file).read_text()
    assert "torch.log(x.to(torch.float64))" in src.splitlines()[int(line) - 1]
    (probe,) = [p for p in iter_probes("reference") if p.name == "step"]
    wide = {(n.aval.dtype, n.src) for n in probe.graph.nodes
            if n.aval is not None and n.aval.dtype in ("int64", "float64")}
    assert ("float64", dtype_drift.FP64_SITE) in wide
    assert any(dt == "int64" and src.startswith("core/events.py")
               for dt, src in wide)
    assert dtype_drift.check(probe) == []
    assert set(dtype_drift.EXEMPTIONS) == {"int64", "float64"}
    # a torch whose make_fx keeps no frames leaves the nodes without a
    # src: the decode is then known by its shape alone
    for n in probe.graph.nodes:
        n.src = n.path = ""
    assert dtype_drift.check(probe) == []
    probe, rule = EXTRA["f64_tau"]()
    for n in probe.graph.nodes:
        n.src = n.path = ""
    assert {f.rule for f in analyze_probe(probe)} == {rule}


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z24multistep_counter_kernelILb0ELb0EEvPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z24multistep_counter_kernelILb0ELb0EEvPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2624 bytes smem, 428 bytes cmem[0]
ptxas info    : Compiling entry function '_Z24multistep_counter_kernelILb1ELb0EEvPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z24multistep_counter_kernelILb1ELb0EEvPKfPf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 2624 bytes smem, 428 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17decode_eta_kernelPKjPfxi' for 'sm_90a'
ptxas info    : Function properties for _Z17decode_eta_kernelPKjPfxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 380 bytes cmem[0]
"""


def test_ptxas_log_parser(tmp_path, monkeypatch):
    got = _build.parse_ptxas(PTXAS_LOG)
    assert got["_Z17decode_eta_kernelPKjPfxi"] == {
        "registers": 18, "static_smem": 0, "stack": 0, "spill_stores": 0,
        "spill_loads": 0}
    assert got["_Z24multistep_counter_kernelILb1ELb0EEvPKfPf"] == {
        "registers": 56, "static_smem": 2624, "stack": 8,
        "spill_stores": 12, "spill_loads": 16}
    # a kernel's figures: the largest over its instantiations
    lib = tmp_path / "libpdes_multistep_counter-0.so"
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    info = _build.ptxas_info("pdes_multistep_counter",
                             "multistep_counter_kernel")
    assert info == {"registers": 56, "static_smem": 2624, "stack": 8,
                    "spill_stores": 12, "spill_loads": 16}
    assert _build.ptxas_info("pdes_multistep_counter", "nope") is None
    # with the log the budget rule reads registers x threads
    from repro_torch.analysis.rules import vmem
    row = vmem.budget_of("pdes_multistep_counter",
                         pdes_multistep.launch_plan(4, 10_000))
    assert row["ptxas"] == info and row["over"] == []
    row = vmem.budget_of("pdes_multistep_counter",
                         pdes_multistep.launch_plan(
                             4, tiling.MAX_STREAM_RING_L + 1))
    assert len(row["over"]) == 1 and "shared memory" in row["over"][0]
    monkeypatch.setattr(_build, "ptxas_info",
                        lambda *a: dict(info, registers=300))
    row = vmem.budget_of("pdes_multistep_counter",
                         pdes_multistep.launch_plan(4, 10_000))
    assert any("registers" in o for o in row["over"])


class _FakeLib:
    """Stands in for a kernel library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.mark.parametrize("L", [16, 300, 10_000, 131_072, 1 << 20])
def test_launch_plan_is_what_the_wrappers_launch(L, monkeypatch):
    """Each wrapper's raw launcher passes its plan's grid and block; the
    sources' launch constants are the plan's.  A ring kernel has one
    launcher, which takes the plan's blocks a ring, segment and kept PEs,
    and over a cooperative grid a workspace of the wrapper's size (none on
    one block)."""
    fake = _FakeLib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    for mod, attr in ((pdes_multistep, "_lib"), (pdes_multistep, "_bits_lib"),
                      (pdes_step, "_lib")):
        monkeypatch.setattr(mod, attr, lambda: fake)
    B, K = 3, 5
    tau = torch.zeros((B, L))
    stats = torch.zeros((6, K, B))
    kw = dict(n_v=4, delta=1.0, rd_mode=False, border_both=False)
    plan = pdes_multistep.launch_plan(B, L)
    pdes_multistep.counter_launch(tau, tau.clone(), stats, None, None,
                                  (0, 0, 0, 0), **kw)
    pdes_multistep.bits_launch(tau, torch.empty((K, B, L, 2),
                                                dtype=torch.int32),
                               tau.clone(), stats, **kw)
    (n1, a1), (n3, a3) = fake.calls
    assert (n1, n3) == ("pdes_multistep_counter_launch",
                        "pdes_multistep_launch")
    shape = (B, L, K, plan["threads"] // 32, plan["ring_grid"], plan["seg"],
             plan["seg"])
    assert a1[5:12] == shape and a3[4:11] == shape
    assert plan["grid"] == (plan["ring_grid"] * B,)
    if plan["ring_grid"] > 1:  # the workspace the launcher's layout needs
        need = B * (128 + 2 * plan["ring_grid"] * 8 * 4)
        assert a1[-2] == a3[-2] == need
    else:
        assert a1[-3:-1] == a3[-3:-1] == (None, 0)
    assert plan["dynamic_smem"] == 4 * plan["seg"] and plan["static_smem"] \
        <= SMEM_PER_BLOCK
    ring = (CSRC / "pdes_ring.cuh").read_text()
    assert "const int smem = seg * (int)sizeof(float);" in ring
    assert "kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(args...);" \
        in ring
    assert "attr.id = cudaLaunchAttributeCooperative;" in ring
    assert "cfg.gridDim = dim3((unsigned)(rings * grid), 1, 1);" in ring
    for src in ("pdes_multistep_counter.cu", "pdes_multistep.cu"):
        text = (CSRC / src).read_text()
        assert "if (grid == 1)\n    return ring_block_launch(" in text
        assert text.count("ring_grid_launch(") >= 1

    fake.calls.clear()
    plan = pdes_step.launch_plan(B, L)
    sp = tiling.step_plan(L)
    pdes_step.launch(torch.zeros((B, L + 2)), torch.zeros((B, L, 2)),
                     torch.zeros((B, 1)), torch.zeros((B, L)),
                     torch.zeros((6, B)), **kw)
    ((_, a2),) = fake.calls
    assert a2[5:7] == (B, L)
    assert a2[11:18] == (plan["cluster"], plan["threads"], plan["rows"],
                         sp.seg, sp.tile, int(sp.keep), plan["dynamic_smem"])
    assert plan["grid"] == (plan["cluster"] * -(-B // plan["rows"]),)
    src = (CSRC / "pdes_step.cu").read_text()
    assert f"constexpr int kMaxThreads = {tiling.STEP_THREADS};" in src
    assert f"constexpr int kPairs = {tiling.STEP_PAIRS};" in src
    assert "cudaLaunchKernelEx(" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cluster * ((B + rows - 1) / rows), cluster, threads, smem," in src
    assert "kernel_for(threads)" in src
    assert "smem != 4 * rows * group_floats(seg, keep)" in src
    assert "return keep ? (seg + 3) & ~3 : 0;" in src
    assert plan["dynamic_smem"] == sp.smem <= SMEM_PER_BLOCK

    src = (CSRC / "threefry_bits.cu").read_text()
    assert f"constexpr int kThreads = {threefry.THREADS};" in src
    assert f"constexpr int kPairsPerThread = {threefry.PAIRS_PER_THREAD};" \
        in src
    plan = threefry.launch_plan(K, B * L)
    assert plan["grid"] == (-(-B * L // 1024), K)


@pytest.mark.parametrize("L", [tiling.MAX_GRID_RING_L + 32, 1 << 23])
def test_stream_launch_is_the_plans(L, monkeypatch):
    """B1's raw launcher passes a ring of the stream tier the plan's
    blocks, segment and the PEs it keeps in shared memory, and the grid's
    workspace, and the C entry takes the stream instantiation for it
    (fewer kept PEs than the segment); the source sizes the blocks' shared
    memory from those kept PEs; the wrapper counts the launch's bytes in
    device memory from the plan."""
    fake = _FakeLib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(pdes_multistep, "_lib", lambda: fake)
    B, K = 2, 3
    tau = torch.zeros((B, L))
    plan = pdes_multistep.launch_plan(B, L)
    p = tiling.ring_plan(L)
    pdes_multistep.counter_launch(tau, tau.clone(), torch.zeros((6, K, B)),
                                  None, None, (0, 0, 0, 0), n_v=4, delta=1.0,
                                  rd_mode=False, border_both=False)
    ((name, args),) = fake.calls
    assert name == "pdes_multistep_counter_launch"
    assert args[5:12] == (B, L, K, plan["threads"] // 32, plan["ring_grid"],
                          plan["seg"], plan["dynamic_smem"] // 4)
    assert plan["seg"] - plan["dynamic_smem"] // 4 == plan["offchip_seg"] > 0
    assert args[-2] == B * (128 + 2 * plan["ring_grid"] * 8 * 4)
    ring = (CSRC / "pdes_ring.cuh").read_text()
    assert "const int smem = keep * (int)sizeof(float);" in ring
    b1 = (CSRC / "pdes_multistep_counter.cu").read_text()
    assert "if (keep == seg)\n    return ring_grid_launch(" in b1
    assert "multistep_counter_stream_kernel<false, false>),\n" \
        "      B, L, K, warps, grid, seg, keep, work," in b1
    assert pdes_multistep.offchip_bytes_of(B, L, K) == \
        8 * B * K * p.offchip_pes(L)


@pytest.mark.parametrize("L", [10_000, 1 << 20, 1 << 23])
def test_counter_launch_passes_its_rebase_flag(L, monkeypatch):
    """B1's raw launcher passes ``rebase`` to the C entry after the rule
    flags (the window's flag, off, after it), off unless asked for, on
    every tier."""
    fake = _FakeLib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(pdes_multistep, "_lib", lambda: fake)
    B, K = 2, 3
    tau = torch.zeros((B, L))
    kw = dict(n_v=4, delta=1.0, rd_mode=True, border_both=True)
    for rebase in (None, False, True):
        more = {} if rebase is None else {"rebase": rebase}
        pdes_multistep.counter_launch(tau, tau.clone(),
                                      torch.zeros((6, K, B)), None, None,
                                      (0, 0, 0, 0), **kw, **more)
    flags = [args[-7:-3] for _, args in fake.calls]
    assert flags == [(1, 1, 0, 0), (1, 1, 0, 0), (1, 1, 1, 0)]


@pytest.mark.parametrize("L", [10_000, 1 << 20, 1 << 23])
def test_counter_launch_passes_its_stale_flag(L, monkeypatch):
    """B1's raw launcher passes ``stale`` to the C entry after ``rebase``,
    off unless asked for, on every tier; the C entry takes each tier's
    ``kStale`` instantiations for it."""
    fake = _FakeLib()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(pdes_multistep, "_lib", lambda: fake)
    B, K = 2, 3
    tau = torch.zeros((B, L))
    kw = dict(n_v=4, delta=1.0, rd_mode=False, border_both=False)
    for more in ({}, {"stale": False}, {"stale": True},
                 {"stale": True, "rebase": True}):
        pdes_multistep.counter_launch(tau, tau.clone(),
                                      torch.zeros((6, K, B)), None, None,
                                      (0, 0, 0, 0), **kw, **more)
    flags = [args[-5:-3] for _, args in fake.calls]
    assert flags == [(0, 0), (0, 0), (0, 1), (1, 1)]
    b1 = (CSRC / "pdes_multistep_counter.cu").read_text()
    for tier in ("", "_grid", "_stream"):
        assert re.search(r"stale \? ring_kernel\(rd_mode, border_both,\s+"
                         rf"multistep_counter{tier}_kernel<true, false, true>",
                         b1), tier


@pytest.mark.parametrize("case", ["ring", "step", "cluster"])
def test_vmem_budget_holds_each_block_of_a_cluster(case):
    """Each block of a launch is held to one block's budget, B2's cluster
    to the portable size; only the ring kernels' findings point at a
    split over a cooperative grid (B2's blocks hold a segment each
    already)."""
    from repro_torch.analysis.probes import KernelCall, Probe
    from repro_torch.analysis.rules import vmem
    L = {"ring": tiling.MAX_STREAM_RING_L + 1, "step": 65_536,
         "cluster": 65_536}[case]
    kernel = "pdes_multistep_counter" if case == "ring" else "pdes_step"
    plan = (pdes_multistep.launch_plan(4, L) if case == "ring"
            else pdes_step.launch_plan(32, L))
    budget = vmem.DEFAULT_BUDGET
    if case == "step":
        budget = plan["dynamic_smem"]          # one block's, not the cluster's
        assert vmem.budget_of(kernel, plan, budget + plan["static_smem"])[
            "over"] == []
    if case == "cluster":
        plan = dict(plan, cluster=2 * vmem.PORTABLE_CLUSTER)
    row = vmem.budget_of(kernel, plan, budget)
    assert len(row["over"]) == 1
    assert ("cluster of 16 blocks" if case == "cluster" else
            "shared memory") in row["over"][0]
    probe = Probe("p", backend="fixture", graph=None, tau_in=0, tau_out=0,
                  ring_widths=frozenset(), L_ring=L, delta=1.0,
                  delta_input=None,
                  kernels=[KernelCall(kernel=kernel, plan=plan, src="x:1")])
    (f,) = vmem.check(probe, vmem_budget=budget)
    assert ("need a cooperative grid" in f.message) == (case == "ring")


@pytest.mark.parametrize("L", [65_536, 131_072, 1 << 20,
                               tiling.MAX_GRID_RING_L + 1,
                               tiling.MAX_STREAM_RING_L + 1])
def test_vmem_budget_of_a_ring_split_over_a_cluster(L, monkeypatch):
    """A ring over a cooperative grid is held block by block, against the
    ptxas figures of the instantiation its plan launches: quiet at 65,536
    PEs (2 blocks), at 131,072 (3 blocks) and at the paper's 2^20 (22
    blocks); past the grid's cap
    B1 is quiet on its stream tier and B3 fires, and past the stream
    tier's both fire; each finding names every limit of its kernel."""
    from repro_torch.analysis.probes import KernelCall, Probe
    from repro_torch.analysis.rules import vmem
    plans = {k: pdes_multistep.launch_plan(4, L, bits=k == "pdes_multistep")
             for k in vmem.RING_KERNELS}
    for plan in plans.values():
        assert "cluster" not in plan
        assert plan["ring_grid"] == {65_536: 2, 131_072: 3, 1 << 20: 22}.get(
            L, tiling.RING_MAX_GRID_BLOCKS)
    probe = Probe("p", backend="fixture", graph=None, tau_in=0, tau_out=0,
                  ring_widths=frozenset(), L_ring=L, delta=1.0,
                  delta_input=None,
                  kernels=[KernelCall(kernel=k, plan=plans[k], src="x:1")
                           for k in vmem.RING_KERNELS])
    findings = vmem.check(probe)
    plan = plans["pdes_multistep_counter"]
    if L <= 1 << 20:          # read against the launched instantiations
        assert findings == []
        asked = []
        monkeypatch.setattr(_build, "ptxas_info",
                            lambda lib, fn: asked.append((lib, fn)))
        for k in vmem.RING_KERNELS:
            vmem.budget_of(k, plan)
        assert asked == [("pdes_multistep_counter",
                          "multistep_counter_grid_kernel"),
                         ("pdes_multistep", "multistep_grid_kernel")]
    else:
        fire = (["pdes_multistep"] if L == tiling.MAX_GRID_RING_L + 1
                else list(vmem.RING_KERNELS))
        assert [f.op for f in findings] == fire
        for f in findings:
            assert "shared memory" in f.message
            assert f"L={tiling.MAX_RING_L}" in f.message
            assert "cluster" not in f.message
            assert f"L={tiling.MAX_GRID_RING_L}" in f.message
            assert (f"L={tiling.MAX_STREAM_RING_L}" in f.message) == (
                f.op == "pdes_multistep_counter")
        if L == tiling.MAX_GRID_RING_L + 1:  # B1's stream instantiation
            asked = []
            monkeypatch.setattr(_build, "ptxas_info",
                                lambda lib, fn: asked.append((lib, fn)))
            assert plan["tier"] == "stream"
            assert vmem.budget_of("pdes_multistep_counter", plan)["over"] \
                == []
            assert asked == [("pdes_multistep_counter",
                              "multistep_counter_stream_kernel")]
