"""Choose the tile of the prefill kernel's bf16 body on the card.

Builds variants of ``csrc/flash_prefill.cu`` whose tile constants differ
(``kTcKeys`` keys a ring stage, ``kTcStages`` ring stages,
``kTcCtasPerSm`` the ``__launch_bounds__`` minimum), holds each against the
plain version at the edges of the tile, and times them in turns at the
shapes of the dense reference's prefills (llama3-8b: H 32, Hkv 8, D 128,
one lane at Sq = Skv = 512, 640, 1040, 1568).  Run from the
repository root on a machine with an NVIDIA card:

    PYTHONPATH=src python -m repro_torch.kernels.flash_tiles

Each variant is the checked-in source with its constants replaced, built
with ``build.nvcc_command`` into the build directory and swapped in for the
wrapper's library; times are CUDA-event means over 100 launches, taken
for every variant and then again in reverse order.  Nothing in the port
imports this module.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build, flash_prefill, ref

VARIANTS = {                       # label: constants replaced
    "64 keys, 2 stages, 2 CTAs/SM": {},
    "128 keys, 2 stages, 1 CTA/SM": dict(kTcKeys=128, kTcCtasPerSm=1),
    "64 keys, 3 stages, 1 CTA/SM": dict(kTcStages=3, kTcCtasPerSm=1),
}
SHAPES = (512, 640, 1040, 1568)
EDGES = ((2, 45, 300, 32, 8, 128, 200), (1, 3, 200, 64, 1, 128, 150),
         (1, 50, 60, 10, 2, 64, 3), (1, 1568, 1568, 32, 8, 128, 0))


def variant_source(consts) -> str:
    src = (build.CSRC / f"{flash_prefill.NAME}.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"no single constant {name} in the source")
    return src


def build_variants():
    """{label: loaded library}, one nvcc per variant, started together."""
    build.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, consts) in enumerate(VARIANTS.items()):
        src = build.BUILD / f"flash_tiles_{i}.cu"
        src.write_text(variant_source(consts))
        lib = src.with_suffix(".so")
        procs[label] = (subprocess.Popen(
            build.nvcc_command(src, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc failed\n{text}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def use(lib):
    build._loaded[flash_prefill.NAME] = lib
    flash_prefill._fns.clear()


def inputs(gen, B, Sq, Skv, H, Hkv, D):
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(torch.bfloat16)
                 for shape in ((B, Sq, H, D), (B, Skv, Hkv, D),
                               (B, Skv, Hkv, D)))


def event_ms(fn, iters=100, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = build._loaded.get(flash_prefill.NAME)
    libs = build_variants()
    try:
        for label, lib in libs.items():
            use(lib)
            worst = 0.0
            for shape in EDGES:
                q, k, v = inputs(gen, *shape[:6])
                got = flash_prefill.flash_prefill(q, k, v, shape[6]).float()
                want = ref.flash_prefill_ref(q, k, v, shape[6]).float()
                worst = max(worst, ((got - want).abs().max()
                                    / want.abs().max()).item())
            print(f"{label}: {flash_prefill.resources(torch.bfloat16, 128)}"
                  f"; worst error {worst:.3g} x max|plain|")
            if worst > 2e-2:
                raise RuntimeError(f"{label} disagrees with the plain version")
        order = list(libs) + list(libs)[::-1]
        total = dict.fromkeys(libs, 0.0)
        for S in SHAPES:
            q, k, v = inputs(gen, 1, S, S, 32, 8, 128)
            times = {label: [] for label in libs}
            for label in order:
                use(libs[label])
                times[label].append(event_ms(
                    lambda: flash_prefill.flash_prefill(q, k, v, 0)))
            for label, t in times.items():
                total[label] += sum(t) / len(t)
            print(f"S = {S}: " + "; ".join(
                f"{label} {sum(t) / len(t):.4f} ms" for label, t in
                times.items()))
        print("over the 4 shapes: " + "; ".join(
            f"{label} {t:.4f} ms" for label, t in total.items())
            + f" ({card})")
    finally:
        if saved is None:
            build._loaded.pop(flash_prefill.NAME, None)
        else:
            build._loaded[flash_prefill.NAME] = saved
        flash_prefill._fns.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
