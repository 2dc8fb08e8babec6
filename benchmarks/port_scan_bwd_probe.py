"""Where a build of the selective-scan backward (`mamba_scan_bwd.cu`)
spends its time, on one NVIDIA card:

    git archive <commit> src/repro_torch/kernels | tar -x -C .archive/k
    python3 -m benchmarks.port_scan_bwd_probe --kernels .archive/k \\
        [--out chiprun_out/scan_bwd_probe.json]

`--kernels DIR` names a copy of the port's kernels (default: this
checkout's).  Its `mamba_scan/mamba_scan_bwd.cu` is built with this
checkout's `nvcc` flags, together with every variant below whose anchor
text the source holds (the variants are timing probes and give wrong
gradients):

- (b) the dB and dC sums over the block's channels skipped (the loop
  that reads the per-step terms back from shared memory);
- (c) the second rebuild of each sub-chunk replaced by values already
  at hand (no exponential, no state update);

and of PR 28's:

- (d) the sums across lanes (the shuffles of dB / dC and of dx / ddt)
  replaced by one register add each;
- (e) the helper warps' sums of the walk warps' terms skipped;
- (f) the first part of a ds-16 span walked on its saved start, its
  states not rebuilt from the stored a_t.

For each build: ptxas's registers and spills, the main kernel's SASS
instruction count by opcode (`cuobjdump -sass`), its exponentials
(`MUFU.EX2`) and instructions per (step, state) of one pass of its span
loop (the static count of the loop body over the steps and states one
thread walks in it), and the call's time at (1, 4096, 16384, 16) by
CUDA events around the C launch (median of 10), the builds in turns (in
order, then in reverse).  The inputs are chip_smoke.py's phase-24 distribution;
the saved states the build reads are made with this checkout's forward
kernel at the build's own spacing (`mamba_scan_bwd_chunk`).  Imports
neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 4096, 16384, 16)
SRC = Path("mamba_scan") / "mamba_scan_bwd.cu"

# label: [(anchor, replacement), ...], regexes over PR 27's source (b,
# c) or PR 28's (d-f); a variant is built when all its anchors match
VARIANTS = {
    "b: dB/dC block sums skipped": [(
        r"      // dC and dB: the block's sums over its channels, in channel "
        r"order\n.*?(?=      // dx and ddt)", "")],
    "c: second rebuild from values at hand": [(
        r"hp\[u\]\[s\] = h\[s\];\n\s*ea\[u\]\[s\] = expf\(d \* av\[s\]\);\n"
        r"\s*const float dbx = dxv \* bs\[i \* DS \+ j \* NS \+ s\];\n"
        r"\s*h\[s\] = ea\[u\]\[s\] \* h\[s\] \+ dbx;",
        "hp[u][s] = ckpt[k][s];\n            ea[u][s] = dxv;")],
    "d: no sums across lanes": [
        (r"reduce4<SG, 2 \* SG, kCm3>\(", "add4("),
        (r"reduce4<1, 2, kSm3>\(", "add4("),
        (r"(?=struct Args \{)",
         "__device__ __forceinline__ float add4(float a, float b, float c, "
         "float d, int) {\n  return (a + b) + (c + d);\n}\n\n")],
    "e: no block sums in the helpers": [(
        r"for \(int jj = 0; jj < kJ; \+\+jj\) \{",
        "for (int jj = 0; jj < 0; ++jj) {")],
    "f: first part's states from values at hand": [(
        r"rebuild\(u, false, hs\);", "")],
}


def _events_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _build(src_text: str, out: Path) -> dict:
    """nvcc with this checkout's flags, then the main kernel's SASS."""
    from repro_torch.kernels import build
    cu = out.with_suffix(".cu")
    cu.write_text(src_text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    out.with_suffix(".sass").write_text(sass)
    return {"lib": ctypes.CDLL(str(out)), "ptxas": ptxas,
            "sass": _sass_counts(sass)}


def _sass_counts(sass: str) -> dict:
    """Per function of the main kernel (ds 16): opcode counts, and the
    body of its longest backward branch (the span loop)."""
    funcs = re.split(r"\n\s*Function : ", sass)
    res = {}
    for f in funcs[1:]:
        name = f.split("\n", 1)[0].strip()
        if "mamba_scan_bwd" not in name or "reduce" in name \
                or "Li16E" not in name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][\w.]*)", f)
        ops = [(int(a, 16), op) for a, _, op in ins]
        counts = collections.Counter(op.split(".")[0] for _, op in ops)
        exps = sum(1 for _, op in ops if op.startswith("MUFU.EX2"))
        # backward branches (BRA to an earlier address): the loops
        loops = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA"
                             r"(?:\.\w+)*\s+(?:\w+,\s*)?0x([0-9a-f]+)", f):
            at, to = int(m.group(1), 16), int(m.group(2), 16)
            if to < at:
                body = [op for a, op in ops if to <= a <= at]
                loops.append({"from": hex(to), "to": hex(at),
                              "instructions": len(body),
                              "exp2": sum(op.startswith("MUFU.EX2")
                                          for op in body)})
        res[name] = {"instructions": len(ops), "exp2": exps,
                     "by_opcode": dict(counts.most_common()),
                     "loops": sorted(loops, key=lambda d: -d["instructions"])}
    return res


def _inputs(seed: int, spacing: int):
    """chip_smoke.py's phase-24 inputs at SHAPE and the forward's states
    every `spacing` steps (this checkout's serve launch, tile by tile)."""
    import torch
    from repro_torch.kernels.mamba_scan import ops
    b, t, di, ds = SHAPE
    g = torch.Generator("cuda").manual_seed(seed)

    def n(*shp):
        return torch.randn(shp, generator=g, device="cuda")
    x, dt = 0.5 * n(b, t, di), torch.nn.functional.softplus(n(b, t, di) - 1)
    bm, cm = 0.5 * n(b, t, ds), 0.5 * n(b, t, ds)
    a, dy = -torch.exp(0.3 * n(di, ds)), n(b, t, di)
    h = torch.zeros((b, di, ds), device="cuda")
    states = []
    for t0 in range(0, t, spacing):
        states.append(h)
        sl = slice(t0, t0 + spacing)
        _, h = ops.mamba_scan(x[:, sl], dt[:, sl], bm[:, sl], cm[:, sl], a,
                              h0=h)
    return (x, dt, bm, cm, a, dy), torch.stack(states)


def _caller(lib, ins, chunks):
    import torch
    x, dt, bm, cm, a, dy = ins
    b, t, di = x.shape
    ds = bm.shape[-1]
    rows_fn = getattr(lib, "mamba_scan_bwd_rows", None) \
        or lib.mamba_scan_bwd_blocks
    rows_fn.argtypes, rows_fn.restype = [ctypes.c_int], ctypes.c_int
    lib.mamba_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 16 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_scan_bwd_launch.restype = ctypes.c_int

    def e(*shape):
        return torch.empty(shape, device="cuda")
    outs = [e(b, t, di), e(b, t, di), e(b, t, ds), e(b, t, ds), e(di, ds)]
    part, da_part = e(rows_fn(di), b, t, 2 * ds), e(b, di, ds)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.mamba_scan_bwd_launch(
            *(z.data_ptr() for z in (x, dt, bm, cm, a, chunks, dy)), None,
            *(z.data_ptr() for z in outs), None, part.data_ptr(),
            da_part.data_ptr(), b, t, di, ds, stream)
        if rc != 0:
            raise RuntimeError(f"mamba_scan_bwd_launch: cudaError {rc}")
        return outs
    return call, part.numel() * 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", type=Path,
                    default=ROOT / "src" / "repro_torch" / "kernels",
                    help="a copy of the port's kernels (src/repro_torch/"
                    "kernels of some commit)")
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_scan_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    kdir = args.kernels
    if (kdir / "src" / "repro_torch" / "kernels").is_dir():
        kdir = kdir / "src" / "repro_torch" / "kernels"
    src = (kdir / SRC).read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"a: as is": src}
    for label, edits in VARIANTS.items():
        new = src
        for pat, rep in edits:
            new, n = re.subn(pat, rep, new, count=1, flags=re.S)
            if not n:
                print(f"{label}: anchor not in this source; not built")
                break
        else:
            texts[label] = new
    builds = {}
    for i, (label, text) in enumerate(texts.items()):
        builds[label] = _build(text, out_dir / f"v{i}.so")
        print(f"{label}: ptxas {builds[label]['ptxas']}")
        for fn, c in builds[label]["sass"].items():
            print(f"  {fn[:70]}: {c['instructions']} SASS instructions, "
                  f"{c['exp2']} MUFU.EX2; loops (first 3) "
                  f"{json.dumps(c['loops'][:3])}; by opcode "
                  f"{json.dumps(dict(list(c['by_opcode'].items())[:25]))}")
    spacing = {}
    for label, bl in builds.items():
        bl["lib"].mamba_scan_bwd_chunk.restype = ctypes.c_int
        spacing[label] = bl["lib"].mamba_scan_bwd_chunk()
    res = {"card": card, "shape": SHAPE, "builds": {}}
    ins, chunks = _inputs(24, spacing["a: as is"])
    calls = {}
    for label, bl in builds.items():
        calls[label], part_bytes = _caller(bl["lib"], ins, chunks)
    ref_out = [z.clone() for z in calls["a: as is"]()]
    torch.cuda.synchronize()
    order = list(calls) + list(calls)[::-1]
    times = collections.defaultdict(list)
    for label in order:
        times[label].append(_events_ms(calls[label]))
    for label, bl in builds.items():
        got = calls[label]()
        torch.cuda.synchronize()
        same = [bool(torch.equal(g, r)) for g, r in zip(got, ref_out)]
        res["builds"][label] = {"ptxas": bl["ptxas"], "sass": bl["sass"],
                                "ms": times[label],
                                "bitwise_as_a (dx, ddt, dB, dC, dA)": same,
                                "partial_bytes": part_bytes,
                                "spacing": spacing[label]}
        print(f"{label}: {' / '.join(f'{m:.4f}' for m in times[label])} ms "
              f"a call (CUDA events, median of 10; in turns); outputs "
              f"bitwise (a)'s (dx, ddt, dB, dC, dA): {same}; partials "
              f"{part_bytes / 1e6:.1f} MB")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
