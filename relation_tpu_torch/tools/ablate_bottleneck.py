"""Where the time of the bottleneck kernel (csrc/bottleneck.cu) goes, on one
CUDA card, by switching its parts off one at a time.

    python3 -m relation_tpu_torch.tools.ablate_bottleneck

Builds variants of csrc/bottleneck.cu, each one text substitution away from
the source (tools/_ablate.py: one nvcc per variant, in parallel, into
relation_tpu_torch/_build/ablate_bottleneck/), and times each on the same
seeded inputs with CUDA events: the identity-block stack at res4 (B=22, [38, 64, 1024], Cmid 256), at res4
with B=1, at res3 (B=3) and res2 (B=2), and the projection block at res4a,
res3a and res2a of the 608x1024 trunk. A variant that switches a part off
computes garbage; a time marked * is from a variant whose output differs
from the full kernel's. Variants:

    full     the kernel as it is
    nomma    no wgmma (loads, waits and epilogues stay)
    noload   no TMA loads (the producer arrives on the barrier itself)
    nodeps   no waits on other items: what the work costs without the chain
             of phases
    noepi    no epilogue stores
    bn64     BN = 64 at every shape; bn128: BN = 128 wherever the channel
             counts allow it

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms

SRC = "bottleneck.cu"
RULE = "p.Cmid % 128 == 0 && p.Cout % 128 == 0 && p.T * (p.Cmid / 128) >= sms"
VARIANTS = {
    "full": [],
    "nomma": [(SRC, "wgmma_step<BN>(acc, da + 2 * kk, db + 128 * kk);", "")],
    "noload": [(SRC, "mbar_expect_tx(full(s), kStage);\n"
                "        issue<BN>(p, it, ks, a_tile(s), b_tile(s), full(s));",
                "mbar_arrive(full(s));")],
    "nodeps": [(SRC, "      wait_deps(p, it);\n", "")],
    "noepi": [(SRC, "      if (goff[k] < 0) continue;",
               "      if (goff[k] < 0 || goff[k] >= 0) continue;")],
    "bn64": [(SRC, RULE, "false")],
    "bn128": [(SRC, RULE, "p.Cmid % 128 == 0 && p.Cout % 128 == 0")],
}
STACKS = [(38, 64, 1024, 256, 22), (38, 64, 1024, 256, 1), (76, 128, 512, 128, 3),
          (152, 256, 256, 64, 2)]
PROJS = [(76, 128, 512, 256, 1024, 2), (152, 256, 256, 128, 512, 2),
         (152, 256, 64, 64, 256, 1)]


def run(libs, entry, argtypes, tensors, ints, out, label):
    dev = out.device
    row, want = [], None
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        args = [_build.ptr(t) for t in tensors] + ints + [_build.stream_ptr(dev)]

        def call():
            _build.check(fn(*args), f"{entry} ({name})")
        call()
        torch.cuda.synchronize()
        if want is None:
            want = out.clone()
        mark = "" if torch.equal(out, want) else "*"
        row.append(f"{name} {time_ms(call, inner=5):.4f}{mark}")
    print(f"{label}: " + "; ".join(row), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_bottleneck needs a CUDA card")
    print_card()
    libs = build_variants("bottleneck", VARIANTS)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)

    def tens(shape, scale, dtype=torch.bfloat16):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                            device=dev).to(dtype)
    f32 = torch.float32
    for H, W, C, Cmid, B in STACKS:
        x = tens((H, W, C), 1.0).relu_()
        w = (tens((B, C, Cmid), C ** -0.5), tens((B, Cmid), 0.1, f32),
             tens((B, 9 * Cmid, Cmid), (9 * Cmid) ** -0.5), tens((B, Cmid), 0.1, f32),
             tens((B, Cmid, C), (4 * Cmid) ** -0.5), tens((B, C), 0.1, f32))
        out = torch.empty_like(x)
        y1 = torch.empty((H * W, Cmid), dtype=torch.bfloat16, device=dev)
        run(libs, "bottleneck_stack",
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            (x,) + w + (out, y1, torch.empty_like(y1)), [B, H, W, C, Cmid], out,
            f"stack [{H},{W},{C}] Cmid {Cmid} B={B}")
    for Hi, Wi, Cin, Cmid, Cout, s in PROJS:
        x = tens((Hi, Wi, Cin), 1.0).relu_()
        w = (tens((Cin, Cout), Cin ** -0.5), tens((Cout,), 0.1, f32),
             tens((Cin, Cmid), Cin ** -0.5), tens((Cmid,), 0.1, f32),
             tens((9 * Cmid, Cmid), (9 * Cmid) ** -0.5), tens((Cmid,), 0.1, f32),
             tens((Cmid, Cout), Cmid ** -0.5), tens((Cout,), 0.1, f32))
        out = torch.empty((Hi // s, Wi // s, Cout), dtype=torch.bfloat16, device=dev)
        y1 = torch.empty((Hi // s * (Wi // s), Cmid), dtype=torch.bfloat16, device=dev)
        run(libs, "proj_bottleneck",
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            (x,) + w + (out, y1, torch.empty_like(y1)),
            [Hi, Wi, Cin, Cmid, Cout, s], out,
            f"proj [{Hi},{Wi},{Cin}] -> Cout {Cout} s={s}")


if __name__ == "__main__":
    main()
