"""Count the instructions of one compiled kernel from its SASS.

    cuobjdump -sass build/kernels/libredsec_pbs.so > pbs.sass      # on the machine with nvcc
    python -m redsec_tpu_torch.scripts.sass_count pbs.sass --kernel blind_rotate_kernelILi1024ELi2E
    python -m redsec_tpu_torch.scripts.sass_count pbs.sass --kernel ... --trips 1,4,...,350,2,3,...

Without a file the script runs ``cuobjdump`` itself on the built library.
It finds the kernel's loops (a branch to an earlier address closes one) and
its larger conditional regions (a branch forward over at least ``--region``
instructions: the body of an ``if``, or the ``else`` that an unconditional
branch jumps over), nests them, and prints for each the instructions of its
body outside anything nested in it, by class: ``mul`` (IMAD, IMUL: the
multiply pipe), ``alu`` (adds, logic, shifts, selects, compares),
``lds``/``sts`` (shared memory), ``ldg``/``stg`` (global memory), ``bar``,
``other`` (moves, branches, ...).  With ``--trips``, one count per loop or
region in the order printed (a loop's trips; for a region the share of its
parent's passes that enter it, 1 or 0 as a rule), it multiplies them out: the instructions
one thread executes in one launch.  Times the threads of a launch and over
the card's instruction rate, that is the least time this code could take.
Instructions under a predicate count as executed.

``--executions`` gives instead, for each loop or region and then for the
straight-line code, how many times one thread executes its own body (what
is not nested deeper) in one launch, not multiplied by the enclosing spans:
that also counts a region whose span holds the ``else`` of another branch
(the compiler lays an ``if`` and its ``else`` out so).  With ``--threads``
(the threads of a launch) it prints the floors of that stream on the H100:
its int32 instructions (``mul`` and ``alu``) at 16.75e12 a second (64 lanes
an SM a clock, as ``chip_smoke.py`` takes the int32 peak) and all its
instructions at twice that (4 warp instructions an SM a clock); with
``--parts`` (``name=first-last;...``, span numbers as printed) the share of
the instructions in each.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

CLASSES = (
    ("mul", ("IMAD", "IMUL")),
    ("alu", ("IADD", "LOP", "SHF", "SHL", "SHR", "SEL", "ISETP", "LEA", "PRMT", "IMNMX",
             "VIMNMX", "IABS", "BFE", "BFI", "FLO", "POPC", "PLOP", "ICMP", "VIADD")),
    ("lds", ("LDS",)), ("sts", ("STS",)), ("ldg", ("LDG", "LD.")), ("stg", ("STG", "ST.")),
    ("bar", ("BAR",)),
)
KINDS = ("mul", "alu", "lds", "sts", "ldg", "stg", "bar", "other")
INT32_RATE = 67e12 / 4      # int32 lanes of the H100 a second, as chip_smoke.py takes it
INSTR_RATE = 2 * INT32_RATE  # thread instructions dispatched a second: 4 warps an SM a clock
INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?);")


def classify(op: str, operands: str) -> str:
    if op.startswith("IMAD") and (".MOV" in op or ".IADD" in op or ".SHL" in op):
        return "other" if ".MOV" in op else "alu"  # moves and adds that the compiler encodes as IMAD
    for name, prefixes in CLASSES:
        if any(op.startswith(p) for p in prefixes):
            return name
    return "other"


def kernel_sass(text: str, kernel: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of the one function whose name holds ``kernel``."""
    out, inside, seen = [], False, 0
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            seen += inside
            continue
        m = INSTR.match(line) if inside else None
        if m:
            out.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if seen != 1:
        raise SystemExit(f"{seen} functions match {kernel!r}")
    return out


def loops_of(instrs, region: int) -> list[tuple[int, int, str]]:
    """(first, last, kind) instruction index of each loop and of each
    conditional region of at least ``region`` instructions, outermost first."""
    index = {a: i for i, (a, _, _) in enumerate(instrs)}
    found, skipped = set(), set()
    for i, (addr, op, operands) in enumerate(instrs):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", operands)
            target = index.get(int(m.group(1), 16)) if m else None
            if target is None:
                continue
            if target <= i:
                found.add((target, i))
            elif target - i - 1 >= region:
                skipped.add((i + 1, target - 1))
    # loops sharing a head are one loop with several back edges
    by_head = {}
    for a, b in found:
        by_head[a] = max(b, by_head.get(a, b))
    spans = [(a, b, "loop") for a, b in by_head.items()] + [(a, b, "region") for a, b in skipped]
    return sorted(spans, key=lambda ab: (ab[0], -ab[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sass", nargs="?", help="output of cuobjdump -sass (default: run it)")
    ap.add_argument("--kernel", required=True, help="substring of the mangled kernel name")
    ap.add_argument("--trips", help="trip count of each loop (1 or 0 for a region), in the "
                                    "order printed")
    ap.add_argument("--executions", help="own-body executions a thread of each loop or "
                                         "region, then of the straight-line code")
    ap.add_argument("--threads", type=float, help="threads of a launch: print the floors")
    ap.add_argument("--parts", help="name=first-last;... spans whose share to print")
    ap.add_argument("--region", type=int, default=48,
                    help="least length of a conditional region that is listed on its own")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as f:
            text = f.read()
    else:
        from redsec_tpu_torch.crypto import kernels as K

        K.build_library(K.SOURCE)
        exe = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
        text = subprocess.run([exe, "-sass", K.library_path(K.SOURCE)], capture_output=True,
                              text=True, check=True).stdout
    instrs = kernel_sass(text, args.kernel)
    loops = loops_of(instrs, args.region)
    trips = [float(t) for t in args.trips.split(",")] if args.trips else [None] * len(loops)
    if len(trips) != len(loops):
        raise SystemExit(f"{len(loops)} loops, {len(trips)} trip counts")
    execs = [float(t) for t in args.executions.split(",")] if args.executions else None
    if execs is not None and len(execs) != len(loops) + 1:
        raise SystemExit(f"{len(loops)} loops and the straight-line code, "
                         f"{len(execs)} execution counts")
    # owner[i] = innermost loop holding instruction i (-1: straight-line code)
    owner = [-1] * len(instrs)
    for li, (a, b, _) in enumerate(loops):  # outermost first, so inner ones overwrite
        for i in range(a, b + 1):
            owner[i] = li
    parent = [max((lj for lj, (c, d, _) in enumerate(loops[:li]) if c <= a and b <= d), default=-1)
              for li, (a, b, _) in enumerate(loops)]
    counts = [collections.Counter() for _ in range(len(loops) + 1)]  # last: straight-line
    for i, (_, op, operands) in enumerate(instrs):
        counts[owner[i]][classify(op, operands)] += 1
    total = collections.Counter()
    rows = []
    for li in list(range(len(loops))) + [-1]:
        mult, lj = 1, li
        while lj >= 0 and trips[lj] is not None:
            mult, lj = mult * trips[lj], parent[lj]
        if execs is not None:
            mult = execs[li]  # the straight-line code is last (li = -1)
        depth, lj = 0, li
        while lj >= 0:
            depth, lj = depth + 1, parent[lj]
        c = counts[li]
        by_class = {k: c[k] for k in KINDS}
        rows.append({"loop": li, "kind": "straight" if li < 0 else loops[li][2], "depth": depth,
                     "body": sum(c.values()), "executed": mult, **by_class})
        for k, v in c.items():
            total[k] += v * mult
        name = "straight-line" if li < 0 else f"{loops[li][2]} {li} (depth {depth}, x{mult:g})"
        print(f"{name:32s} {sum(c.values()):6d} instructions: "
              + " ".join(f"{k} {v}" for k, v in by_class.items()))
    result = {"kernel": args.kernel, "static": len(instrs), "loops": rows}
    if args.trips or execs is not None:
        result["per_thread"] = {k: round(v) for k, v in total.items()}
        result["per_thread_total"] = round(sum(total.values()))
        print(f"one thread executes {result['per_thread_total']} instructions: "
              + " ".join(f"{k} {v}" for k, v in sorted(result["per_thread"].items())))
    if args.threads and result.get("per_thread_total"):
        int32 = total["mul"] + total["alu"]
        result["int32_floor_ms"] = int32 * args.threads / INT32_RATE * 1e3
        result["dispatch_floor_ms"] = sum(total.values()) * args.threads / INSTR_RATE * 1e3
        print(f"floors on the H100 for {args.threads:g} threads: int32 "
              f"{result['int32_floor_ms']:.4f} ms, dispatch {result['dispatch_floor_ms']:.4f} ms")
    if args.parts and result.get("per_thread_total"):
        shares = {}
        for part in args.parts.split(";"):
            name, _, span = part.partition("=")
            lo, _, hi = span.partition("-")
            shares[name] = sum(r["executed"] * r["body"] for r in rows
                               if r["loop"] >= 0 and int(lo) <= r["loop"] <= int(hi or lo))
        result["shares"] = {k: v / result["per_thread_total"] for k, v in shares.items()}
        print("shares of the instructions: " + ", ".join(
            f"{k} {v:.4f}" for k, v in result["shares"].items()))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
