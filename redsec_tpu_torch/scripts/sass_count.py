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
    if args.trips:
        result["per_thread"] = {k: round(v) for k, v in total.items()}
        result["per_thread_total"] = round(sum(total.values()))
        print(f"one thread executes {result['per_thread_total']} instructions: "
              + " ".join(f"{k} {v}" for k, v in sorted(result["per_thread"].items())))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
