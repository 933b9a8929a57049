"""vmem-budget: one H100 block's shared memory and registers, per kernel launch.

The reference budgets each Pallas kernel's VMEM tiles, read off the
``pallas_call``'s BlockSpecs.  On Hopper the scarce resources of a launch
are one block's shared memory and the SM's register file, and both are
static facts of the launch: every kernel wrapper has a pure
``launch_plan(...)`` (grid, threads, dynamic and static shared bytes)
that the wrapper launches with, and the probes record the plan of every
launch the traced call made (``probes.py``).  The rule's public name and
flag stay the reference's (``vmem-budget``, ``--vmem-budget``), so
reports and scripts keep working; the budget is bytes of shared memory a
block may use, by default :data:`DEFAULT_BUDGET` (``tiling.SMEM_PER_BLOCK``).

Where the kernel was built here, ``kernels/_build.py`` kept ``nvcc``'s
``-Xptxas -v`` log beside its library, and the rule also reads the
compiled kernel's registers, static shared memory and spill bytes
(``_build.ptxas_info``).  It fires when static plus dynamic shared memory
passes the budget, or registers times threads pass the 65,536 registers
of an SM, for each block of a launch (a cluster's or a cooperative grid's
blocks each hold their own), or when B2's cluster passes the portable 8;
spills are reported by :func:`kernel_budgets` and do not fire.  A ring
kernel's plan over a grid reads the ptxas figures of its grid
instantiation (B1's stream tier: its stream instantiation).  Without a
log (no ``nvcc`` here) the plan's static figure stands.
"""
from __future__ import annotations

from ...kernels import _build, pdes_multistep, pdes_step, threefry
from ...kernels.tiling import (MAX_GRID_RING_L, MAX_RING_L, MAX_RING_SEG,
                               MAX_STREAM_RING_L, RING_MAX_GRID_BLOCKS,
                               SMEM_PER_BLOCK, STEP_MAX_CLUSTER)
from ..probes import Probe
from ..report import Finding

RULE = "vmem-budget"

DEFAULT_BUDGET = SMEM_PER_BLOCK       # bytes; one H100 block
#: 32-bit registers of one SM (and the most one block may hold)
REGISTERS_PER_SM = 65_536
#: Most blocks of a cluster that every Hopper part schedules
PORTABLE_CLUSTER = STEP_MAX_CLUSTER
#: The kernels that keep a whole ring in the shared memory of one block or
#: of a cooperative grid's blocks
RING_KERNELS = ("pdes_multistep_counter", "pdes_multistep")

#: kernel -> (CUDA source, __global__ function) of its library
SOURCES = {
    "pdes_multistep_counter": ("pdes_multistep_counter",
                               "multistep_counter_kernel"),
    "pdes_step": ("pdes_step", "pdes_step_kernel"),
    "pdes_multistep": ("pdes_multistep", "multistep_kernel"),
    "threefry_bits": ("threefry_bits", "threefry_bits_kernel"),
}
#: ring kernel -> __global__ function of its grid instantiation
GRID_FUNCTIONS = {
    "pdes_multistep_counter": "multistep_counter_grid_kernel",
    "pdes_multistep": "multistep_grid_kernel",
}
#: __global__ function of B1's stream tier (B3 has none)
STREAM_FUNCTION = "multistep_counter_stream_kernel"


def _ptxas(kernel: str, plan: dict):
    lib, fn = SOURCES[kernel]
    if kernel in RING_KERNELS and plan.get("ring_grid", 1) > 1:
        fn = GRID_FUNCTIONS[kernel]
    if kernel == "pdes_multistep_counter" and plan.get("tier") == "stream":
        fn = STREAM_FUNCTION
    return _build.ptxas_info(lib, fn)


def budget_of(kernel: str, plan: dict, budget: int = DEFAULT_BUDGET) -> dict:
    """The plan of one launch against the budget: the plan's numbers, the
    ptxas figures where a log exists, and ``over`` (what fires).  Each
    block of a cluster or a grid is held to the block budget on its own."""
    info = _ptxas(kernel, plan)
    static = plan["static_smem"] if info is None else max(
        plan["static_smem"], info["static_smem"])
    row = {"kernel": kernel, **plan, "static_smem": static,
           "smem": static + plan["dynamic_smem"], "ptxas": info, "over": []}
    if row["smem"] > budget:
        row["over"].append(
            f"shared memory {row['smem']} B ({plan['dynamic_smem']} dynamic "
            f"+ {static} static) > budget {budget} B")
    if info is not None and \
            info["registers"] * plan["threads"] > REGISTERS_PER_SM:
        row["over"].append(
            f"{info['registers']} registers x {plan['threads']} threads > "
            f"{REGISTERS_PER_SM}")
    if plan.get("cluster", 1) > PORTABLE_CLUSTER:
        row["over"].append(f"cluster of {plan['cluster']} blocks > the "
                           f"portable {PORTABLE_CLUSTER}")
    return row


def kernel_budgets(L: int = 10_000, budget: int = DEFAULT_BUDGET,
                   B: int = 448, K: int = 16) -> list:
    """Every kernel's launch at ``L`` (rows ``B``; the generator's for
    ``K`` steps) against the budget, with its ptxas figures (registers,
    static shared bytes, spills) where built: what ``chip_smoke.py``
    phase 16 prints."""
    return [budget_of("pdes_multistep_counter",
                      pdes_multistep.launch_plan(B, L), budget),
            budget_of("pdes_step", pdes_step.launch_plan(B, L), budget),
            budget_of("pdes_multistep",
                      pdes_multistep.launch_plan(B, L, bits=True), budget),
            budget_of("threefry_bits", threefry.launch_plan(K, B * L),
                      budget)]


def check(probe: Probe, vmem_budget: int = DEFAULT_BUDGET, **_) -> list:
    findings, seen = [], set()
    for call in probe.kernels:
        key = (call.kernel, tuple(sorted(call.plan.items())))
        if key in seen:
            continue
        seen.add(key)
        row = budget_of(call.kernel, call.plan, vmem_budget)
        if row["over"]:
            findings.append(Finding(
                rule=RULE, op=call.kernel, path=call.src,
                message=f"launch of {call.plan['grid'][0]} block(s) x "
                        f"{call.plan['threads']} threads: "
                        + "; ".join(row["over"])
                        + (f" (rings above L={MAX_RING_L} need a "
                           f"cooperative grid, and "
                           f"{RING_MAX_GRID_BLOCKS} blocks hold rings up to "
                           f"L={MAX_GRID_RING_L}"
                           + (f"; B1's blocks keep all but {MAX_RING_SEG} "
                              f"PEs of each segment in device memory up to "
                              f"L={MAX_STREAM_RING_L})"
                              if call.kernel == "pdes_multistep_counter"
                              else "; B3 takes no ring past it)")
                           if call.kernel in RING_KERNELS else "")))
    return findings
