"""What a compiled kernel issues for each counter-PRNG draw, by pipe.

    python -m repro_torch.kernels.sass [--source fused_mac] [--sass FILE]

builds ``csrc/<source>.cu`` as `repro_torch.kernels.build` does (so only
where ``nvcc`` is), disassembles it with ``cuobjdump -sass`` (or reads a
saved disassembly), and prints one JSON object per ``__global__``
function: ptxas's registers, stack and spills, the local-memory
instructions (``LDL``/``STL``) in the whole function and on its draw
loop's hot path, and the hot path's instructions per draw by pipe.

The draw loop is the innermost loop that runs at least one Box-Muller
draw (one ``MUFU.RSQ`` each: ``sqrtf``; the precise ``logf`` and
``sincosf`` are polynomials on the FMA pipe).  Its hot path is the
instruction sequence one iteration issues when no argument needs a
slow path: a forward branch is taken where it skips a region that
holds a call or a loop (``sincosf``'s large-argument reduction,
``sqrtf``'s denormal fix-up), and falls through otherwise.

Pipes of an H100 SM (compute capability 9.0; results per clock per SM,
from the arithmetic-instruction throughput table of NVIDIA's CUDA C++
Programming Guide and the pipe names of Nsight Compute's profiling
guide):

- ``alu`` (64): logic, shifts, integer add and compare, float compare
  and select, ``I2FP`` conversions;
- ``fma`` (128): float32 add, multiply and FMA; of these lanes only 64
  (``fmaheavy``) also run the integer multiply-adds (``IMAD*``, and
  ``VIADD`` counted with them), so those have a limit of their own;
- ``xu`` (16): ``MUFU`` special functions and the other conversions;
- ``issue`` (128): the four warp schedulers dispatch one instruction of
  32 threads each per clock, whatever its pipe.

Loads, stores, branches and uniform-datapath instructions are counted
but bound nothing here.  `cycles_per_draw` gives each resource's SM
clocks per draw; a caller's bound is draws x the largest of those over
the SMs' clock rate.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

# results per clock per SM on an H100 (compute capability 9.0)
RATES = {"alu": 64, "fmaheavy": 64, "fma": 128, "xu": 16, "issue": 128}

_FP32 = {"FADD", "FMUL", "FFMA"}
_HEAVY = {"IMAD", "IMUL", "VIADD", "HFMA2"}
_XU = {"MUFU", "F2I", "I2F", "F2F", "FRND"}
_LSU = {"LDG", "STG", "LDL", "STL", "LDS", "STS", "LDC", "LD", "ST",
        "ATOM", "ATOMG", "RED"}
_CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "NOP",
            "WARPSYNC", "BPT"}
_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


@dataclass
class Instr:
    addr: int
    pred: str
    op: str
    args: str

    @property
    def base(self) -> str:
        return self.op.split(".")[0]

    def target(self) -> Optional[int]:
        """A branch's or call's target address, else None."""
        if self.base not in ("BRA", "CALL"):
            return None
        m = re.search(r"0x([0-9a-f]+)", self.args)
        return int(m.group(1), 16) if m else None


def pipe(ins: Instr) -> str:
    base = ins.base
    if base in _FP32:
        return "fma"
    if base in _HEAVY:
        return "fmaheavy"
    if base in _XU:
        return "xu"
    if base in _LSU:
        return "lsu"
    if base in _CONTROL:
        return "control"
    if base.startswith("U") or base in ("S2R", "S2UR", "CS2R"):
        return "uniform"
    if base.startswith("D"):
        return "fp64"
    return "alu"


def parse(text: str) -> Dict[str, List[Instr]]:
    """``cuobjdump -sass`` output -> {mangled function name: its
    instructions in address order}."""
    funcs: Dict[str, List[Instr]] = {}
    cur: Optional[List[Instr]] = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _LINE.match(line)
        if m is None or cur is None:
            continue
        body = m.group(2)
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        op, _, args = body.partition(" ")
        cur.append(Instr(int(m.group(1), 16), pred, op, args.strip()))
    return funcs


def _cold(skipped: List[Instr], start_addr: int) -> bool:
    """Whether a skipped region holds a call or a loop of its own."""
    for ins in skipped:
        t = ins.target()
        if ins.base == "CALL" or (t is not None and t <= ins.addr
                                  and t >= start_addr):
            return True
    return False


def hot_path(instrs: List[Instr], start: int, end: int) -> List[Instr]:
    """The instructions one pass from index `start` to the backward
    branch at index `end` issues when it takes no slow path."""
    at = {ins.addr: i for i, ins in enumerate(instrs)}
    path, i = [], start
    while i <= end:
        ins = instrs[i]
        path.append(ins)
        t = ins.target()
        if i == end or t is None or ins.base == "CALL" or t <= ins.addr:
            i += 1
            continue
        j = at[t]
        if not ins.pred or _cold(instrs[i + 1:j], instrs[i + 1].addr):
            i = j
        else:
            i += 1
    return path


def draw_loop(instrs: List[Instr]) -> Optional[List[Instr]]:
    """The hot path of the innermost loop that draws, or None."""
    at = {ins.addr: i for i, ins in enumerate(instrs)}
    best = None
    for e, ins in enumerate(instrs):
        t = ins.target()
        if ins.base != "BRA" or t is None or t > ins.addr:
            continue
        path = hot_path(instrs, at[t], e)
        if any(p.op == "MUFU.RSQ" for p in path) and (
                best is None or e - at[t] < best[0]):
            best = (e - at[t], path)
    return None if best is None else best[1]


def cycles_per_draw(per_draw: Dict[str, float]) -> Dict[str, float]:
    """SM clocks per draw of each limiting resource, from the
    instructions per draw by pipe."""
    issued = sum(per_draw.values())
    return {"alu": per_draw.get("alu", 0.0) / RATES["alu"],
            "fmaheavy": per_draw.get("fmaheavy", 0.0) / RATES["fmaheavy"],
            "fma": (per_draw.get("fma", 0.0) + per_draw.get("fmaheavy", 0.0))
            / RATES["fma"],
            "xu": per_draw.get("xu", 0.0) / RATES["xu"],
            "issue": issued / RATES["issue"]}


def ptxas_resources(log: str) -> Dict[str, dict]:
    """``-Xptxas -v`` output -> {mangled name: registers, stack, spills}."""
    out: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def short_name(mangled: str) -> str:
    """A function's own name in its mangled symbol: the last component
    of an Itanium nested name (``_ZN...E``) or the plain ``_Z<n>name``,
    e.g. ``fused_partials_kernel``."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        size = int(digits)
        name, rest = rest[len(digits):len(digits) + size], \
            rest[len(digits) + size:]
        if not mangled.startswith("_ZN"):
            break
    return name


def instance_name(mangled: str) -> str:
    """`short_name`, with a template instance's arguments: integers,
    builtin types and named types, e.g. ``flash_tf32_kernel<32, 16>`` or
    ``toy_kernel<16, float>``."""
    name = short_name(mangled)
    at = mangled.find(f"{len(name)}{name}I")
    if at < 0:
        return name
    rest, args = mangled[at + len(str(len(name))) + len(name) + 1:], []
    while rest and rest[0] != "E":
        m = re.match(r"L[a-z](\d+)E", rest)
        if m:
            args.append(m.group(1))
        else:
            m = re.match(r"(\d+)", rest)
            if m:
                size = int(m.group(1))
                args.append(rest[m.end():m.end() + size])
                rest = rest[m.end() + size:]
                continue
            m = re.match(r"[a-z]", rest)
            args.append({"f": "float", "d": "double", "i": "int"}.get(
                rest[0], rest[0]))
        rest = rest[m.end():]
    return f"{name}<{', '.join(args)}>"


def analyse(sass: str, ptxas_log: str = "") -> Dict[str, dict]:
    """{kernel name: its report} for every function of a disassembly,
    each template instance under its own `instance_name`."""
    res = ptxas_resources(ptxas_log)
    report = {}
    for name, instrs in parse(sass).items():
        rec = {"instructions": len(instrs),
               "local_memory_instructions": sum(
                   i.base in ("LDL", "STL") for i in instrs),
               **res.get(name, {})}
        path = draw_loop(instrs)
        if path is not None:
            draws = sum(p.op == "MUFU.RSQ" for p in path)
            by_pipe = Counter(pipe(p) for p in path)
            per_draw = {k: v / draws for k, v in sorted(by_pipe.items())}
            rec.update(
                draw_loop={"first": hex(path[0].addr),
                           "last": hex(path[-1].addr)},
                draws_per_iteration=draws,
                hot_path_instructions=len(path),
                hot_path_local_memory=sum(p.base in ("LDL", "STL")
                                          for p in path),
                per_draw_by_pipe=per_draw,
                per_draw_by_opcode=dict(Counter(
                    p.op for p in path).most_common()),
                cycles_per_draw=cycles_per_draw(per_draw))
        report[instance_name(name)] = rec
    return report


def cuobjdump_path() -> str:
    """``cuobjdump``, beside the ``nvcc`` that builds the kernels."""
    from repro_torch.kernels.build import nvcc_path
    return str(Path(nvcc_path()).with_name("cuobjdump"))


def disassemble(lib) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def report_source(name: str) -> Dict[str, dict]:
    """Build ``csrc/<name>.cu`` (or reuse its library) and analyse it;
    ptxas's figures only where this call built it."""
    from repro_torch.kernels import build
    lib, _, log = build.build(name)
    return analyse(disassemble(lib), log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="fused_mac",
                    help="csrc/<source>.cu to build and disassemble")
    ap.add_argument("--sass", help="analyse this saved cuobjdump -sass "
                                   "output instead of building")
    ap.add_argument("--ptxas", help="with --sass: the -Xptxas -v log")
    a = ap.parse_args(argv)
    if a.sass:
        rep = analyse(Path(a.sass).read_text(),
                      Path(a.ptxas).read_text() if a.ptxas else "")
    else:
        rep = report_source(a.source)
    for name, rec in rep.items():
        print(json.dumps({"kernel": name, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
