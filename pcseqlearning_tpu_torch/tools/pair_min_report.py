"""Registers, spills and instruction mix of pair_min's streamed kernel, and
its time at the reconstruction head's full-width call.

    python pcseqlearning_tpu_torch/tools/pair_min_report.py [--root DIR]
        [--n 32768] [--reps 3] [--sustain 0] [--no-sass] [--sass-out PATH]

Card only. ``--root`` names the tree whose ``pcseqlearning_tpu_torch`` is
measured (default: the one this file lies in), so that two trees can be
compared in one run on one card. The tool:

1. compiles that tree's ``csrc/pair_min.cu`` with the port's nvcc flags into
   a temporary directory and prints ptxas's lines (registers, spills,
   shared memory) for each kernel;
2. disassembles it (``cuobjdump -sass``), splits ``pair_min_stream_kernel``
   into basic blocks and prints, in program order, those that hold at least
   a quarter as many FMUL as the one with the most: the unrolled loop bodies
   of a step, one for each kind of pass. A pair's distance has 3 FMUL, so
   instructions / (FMUL / 3) is what a pair costs in that body, with the
   block's opcodes counted;
3. runs one streamed call at C = 1, P = 27 n, Q = n on the head's key layout
   ((1e3 * batch, polar, azimuth), two batches, all valid), checks it bit
   for bit against ``pair_min_plain``, and times it with CUDA events around
   each call on an idle card (the mean over ``--reps`` calls after one);
4. with ``--sustain N``, times N calls back to back (CUDA events around
   all of them) while ``nvidia-smi`` samples the SM clock and the power
   draw every 100 ms;
5. prints one JSON line (``# pair_min_report {...}``) with the card's name
   and power limit. ``--sass-out`` also writes the kernel's whole listing.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

PAIRS_PER_FMUL = 1 / 3  # (dx * dx, dy * dy, dz * dz) per distance


def _ptxas(lines):
    """ptxas's resource lines, by kernel (mangled name)."""
    out, fn = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
        if fn and ("registers" in line or "spill" in line or "stack frame" in line):
            out.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return out


def _blocks(sass, function):
    """The basic blocks of ``function`` in cuobjdump's listing: lists of
    (opcode, full instruction) split at labels and after control flow."""
    blocks, cur, inside = [], [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = line.split("Function :", 1)[1].strip() == function
            continue
        if not inside:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            if cur:
                blocks.append(cur)
            cur = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        cur.append((op, (m.group(1) + m.group(2)).strip()))
        if op in ("BRA", "BRX", "EXIT", "RET", "JMP", "JMX", "CALL"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def sass_report(lib_path, function, sass_out=None):
    text = subprocess.run(["cuobjdump", "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    if sass_out:
        Path(sass_out).parent.mkdir(parents=True, exist_ok=True)
        Path(sass_out).write_text(text)
    blocks = _blocks(text, function)
    if not blocks:
        return dict(error=f"{function} not found in the SASS")
    fmul = [sum(op == "FMUL" for op, _ in b) for b in blocks]
    hot = [b for b, f in zip(blocks, fmul) if f >= max(fmul) // 4]
    report = []
    for b in hot:
        ops = collections.Counter(op for op, _ in b)
        pairs = ops["FMUL"] * PAIRS_PER_FMUL
        report.append(dict(instructions=len(b), pairs=pairs,
                           per_pair=len(b) / pairs if pairs else None,
                           fsetp_per_pair=ops["FSETP"] / pairs if pairs else None,
                           opcodes=dict(ops.most_common())))
    return dict(function=function, instructions=sum(map(len, blocks)),
                basic_blocks=len(blocks), hot_blocks=report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--n", type=int, default=32_768)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sustain", type=int, default=0)
    ap.add_argument("--no-sass", action="store_true")
    ap.add_argument("--sass-out", default=None)
    args = ap.parse_args(argv)
    # the inputs come from this tree's scene module whatever --root names;
    # then the package is imported again from --root
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from pcseqlearning_tpu_torch.scene import reconstruction_keys

    keys = reconstruction_keys(args.n)
    for name in [m for m in sys.modules if m.split(".")[0] == "pcseqlearning_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from pcseqlearning_tpu_torch.ops import cuda_build
    from pcseqlearning_tpu_torch.ops import pair_min as pm

    if not torch.cuda.is_available():
        raise SystemExit("pair_min_report: no CUDA card")
    assert Path(pm.__file__).resolve().is_relative_to(Path(args.root).resolve())
    out = dict(root=str(Path(args.root).resolve()))
    if not args.no_sass:
        with tempfile.TemporaryDirectory() as tmp:
            lib = Path(tmp) / "pair_min.so"
            proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                                   str(cuda_build.CSRC / "pair_min.cu")],
                                  capture_output=True, text=True, check=True)
            out["ptxas"] = _ptxas((proc.stdout + proc.stderr).splitlines())
            names = [k for k in out["ptxas"] if "pair_min_stream_kernel" in k]
            out["sass"] = (sass_report(lib, names[0], args.sass_out) if names
                           else dict(error="no stream kernel"))
    dev = torch.device("cuda")
    a, b, am, bm = (torch.as_tensor(x).to(dev) for x in keys)
    got = pm.pair_min(a, b, am, bm)
    torch.cuda.synchronize()
    want = pm.pair_min_plain(a, b, am, bm)
    out["mismatches"] = sum(int((g != w).sum()) for g, w in zip(got, want))
    del want
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        pm.pair_min(a, b, am, bm)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    if args.sustain:
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, text=True)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.sustain):
            pm.pair_min(a, b, am, bm)
        e1.record()
        torch.cuda.synchronize()
        smi.terminate()
        samples = [[float(v) for v in line.split(",")]
                   for line in smi.communicate()[0].splitlines() if line.strip()]
        busy = samples[2:-1] or samples  # skip the samples before the first launch ran
        out["sustained"] = dict(calls=args.sustain, ms=e0.elapsed_time(e1) / args.sustain,
                                sm_mhz=sorted(s[0] for s in busy),
                                power_w=max(s[1] for s in busy))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out.update(shape=[1, a.shape[1], b.shape[1]], call_ms=times,
               mean_ms=sum(times) / len(times), card=smi.strip().splitlines()[0],
               stream_launches=pm.pair_min.stream_launches)
    print(f"# pair_min_report {json.dumps(out)}", flush=True)
    return 0 if out["mismatches"] == 0 else 1


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
