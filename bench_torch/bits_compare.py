"""Time builds of the bit kernel (`csrc/segment_bits.cu`) on the same
inputs in one process, in turns: the checkout's source, another one's,
such as a parent commit unpacked with `git archive` into a git-ignored
directory, and any other `.cu` file with the same C entry point given as
`--source TAG=FILE` (a variant under trial). Card only.

    python3 bench_torch/bits_compare.py [--other DIR] [--source TAG=FILE]
        [--rounds N]

Each source is compiled with the port's nvcc flags into
`build/bits_compare/` and called through its C entry point on buffers
allocated once (the kernel alone: no wrapper, no launch count). The
inputs are chip_smoke.py's phase-3 shapes (2^22 rows at 8, 1,024 and 2^21
segments, 58% live, uniform ids) and flows of 2^25 rows, 86% live: ids
sorted into runs of about 565 and of about 2^18 over 2^25 segments, as
a sorted-segment aggregate hands them, and one segment. Every
build's result is held to the plain version (`chip_smoke.plain_bits`),
exactly, before it is timed. Each round times the builds in turns, then
in the reverse order (other, this, the sources, the sources, this, other;
`chip_smoke.device_ms`), and one JSON line per shape, kind and build
gives each round's milliseconds and their median, with the card's name
and power limit on the first line and each build's ptxas report after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "bits_compare"


def build(src: Path, tag: str) -> ctypes.CDLL:
    from spark_tpu_torch.utils import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{tag}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib),
           str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc {src} failed:\n{done.stdout}{done.stderr}")
    # ptxas's registers and spills of each kernel, one line per build
    regs = [ln.strip() for ln in (done.stdout + done.stderr).splitlines()
            if "registers" in ln]
    print(json.dumps({"build": tag, "ptxas": regs}), flush=True)
    bound = ctypes.CDLL(str(lib))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    bound.spark_segment_bits_i64.argtypes = [p, p, p, i64, i32, i32, p, p, p]
    bound.spark_segment_bits_i64.restype = ctypes.c_int
    return bound


def shapes(rng):
    """(label, ids, segments, live share) of each timed input."""
    import numpy as np

    n = 1 << 22
    for segs in (8, 1024, 1 << 21):
        seg = rng.integers(0, segs, n).astype(np.int32)
        yield (f"2^22 rows, {segs:,} segments, 58% live", seg, segs, 0.58)
    big = 1 << 25
    yield ("2^25 rows sorted into runs of about 565 over 2^25 segments, "
           "86% live", cs.sorted_ids(rng, big, big, 565, jitter=True), big,
           0.86)
    yield ("2^25 rows sorted into runs of about 2^18 over 2^25 segments, "
           "86% live", cs.sorted_ids(rng, big, big, 1 << 18, jitter=True),
           big, 0.86)
    yield ("2^25 rows, 1 segment, 86% live", np.zeros(big, np.int32), 1,
           0.86)


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of another checkout")
    ap.add_argument("--source", action="append", default=[],
                    help="TAG=FILE: one more source to build and time")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bits_compare needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip(),
                      "torch": torch.__version__}), flush=True)
    src = "spark_tpu_torch/csrc/segment_bits.cu"
    libs = {}
    if args.other:
        libs["other"] = build(Path(args.other) / src, "other")
    libs["this"] = build(ROOT / src, "this")
    for item in args.source:
        tag, path = item.split("=", 1)
        libs[tag] = build(Path(path), tag)
    order = list(libs) + list(libs)[::-1]
    from spark_tpu_torch.ops import scatter_kernels as sk

    rng = np.random.default_rng(23)
    dev = torch.device("cuda")
    for label, seg, segs, live in shapes(rng):
        vals = cs.bit_values(rng, seg, segs, np.int64)
        mask = rng.random(len(seg)) < live
        v = torch.from_numpy(vals).to(dev)
        m = torch.from_numpy(mask).to(dev)
        g = torch.from_numpy(seg).to(dev)
        count = sk.partition_histogram(g, m, segs)
        out = torch.empty(segs, dtype=torch.int64, device=dev)
        nbytes = len(seg) + int(m.sum()) * 12 + segs * 8
        for kind in sk.BIT_KINDS:
            exp = cs.plain_bits(torch, sk, v, m, g, segs, kind)
            k = sk.BIT_KINDS.index(kind)
            stream = sk._stream(v)

            def launcher(lib):
                return lambda: lib.spark_segment_bits_i64(
                    v.data_ptr(), g.data_ptr(), m.data_ptr(), v.shape[0],
                    segs, k, count.data_ptr(), out.data_ptr(), stream)
            calls = {t: launcher(lib) for t, lib in libs.items()}
            for tag, call in calls.items():
                out.fill_(7)
                if call() != 0:
                    raise SystemExit(f"{tag}: launch failed at {label}")
                torch.cuda.synchronize()
                if not torch.equal(out, exp):
                    raise SystemExit(f"{tag} differs from the plain version "
                                     f"at {label} ({kind})")
            times: dict[str, list] = {t: [] for t in libs}
            for _ in range(args.rounds):
                for tag in order:
                    times[tag].append(cs.device_ms(calls[tag]))
            for tag, ms in times.items():
                print(json.dumps({
                    "shape": label, "kind": kind, "build": tag, "ms": ms,
                    "median_ms": statistics.median(ms),
                    "bound_ms": cs.bound_ms(nbytes)}), flush=True)
        del v, m, g, count, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
