"""Where the time of the conv1 stem kernel (csrc/stem.cu) goes, on one CUDA
card, by switching its parts off one at a time.

    python3 -m relation_tpu_torch.tools.ablate_stem

Parts: the bf16 products (nomma), the magnitude sums that bound their error
(nosab), the exact recompute of the outputs that error could change
(noexact: with it the flag test and the magnitude sums go), the input
loads, the bf16 strip conversion and the output stores.

Builds variants of the source, each a few text substitutions away from it
(tools/_ablate.py: one nvcc per variant, in parallel, into
relation_tpu_torch/_build/ablate_stem/), and times each with CUDA events on
a seeded s2d image of 608x1024 (B=1, Ho=304, Wo=512), the shape of the
flagship's requests. A variant that switches a part off computes garbage; a
time marked * is from a variant whose output differs from the full
kernel's.

Then measures what the exact path is for, with the variant ``noexact``
(the tensor cores' sums alone) against the plain version (the exact sum
rounded once to f32), at the same image and at B=2 of another seed: the
outputs outside the one-bf16-ulp band of chip_smoke.py, the outputs whose
bf16 value differs, and, with scale 1 and bias 0, the largest error the
flipped roundings show, as a share of the products' magnitude sum S (a
lower bound of the tensor cores' error; csrc/stem.cu's exact path assumes
at most 2^-20 S). The full kernel is held to the plain version bit for bit
at both.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import numpy as np
import torch

from relation_tpu_torch.models.backbone import conv1_w4
from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import stem as ST
from relation_tpu_torch.tools._ablate import build_variants, print_card
from relation_tpu_torch.tools.ablate_attention import run

STEM = "stem.cu"
VARIANTS = {
    "full": [],
    # no exact recompute of the outputs near zero after BN
    "noexact": [(STEM, "if (__any_sync(0xffffffffu, mine != 0u)) {",
                 "if (false) {")],
    # no tensor-core products (the B fragments still loaded)
    "nomma": [(STEM, "        mma_bf16(acc[0], a[s], b[0], b[1]);\n"
               "        mma_bf16(acc[1], a[s], b[2], b[3]);",
               "        acc[0][0] += __uint_as_float(b[0]);\n"
               "        acc[1][0] += __uint_as_float(b[2]);")],
    # no magnitude sums (the exact path then never taken)
    "nosab": [(STEM, "        mma_bf16(sab[0], aa, b[0], b[1]);\n"
               "        mma_bf16(sab[1], aa, b[2], b[3]);", "")],
    # no input loads (the strips left as they are)
    "noinput": [(STEM, "  stage_input(stage, x, tile_of(blockIdx.x, th, tw), Ho, Wo);\n", ""),
                (STEM, "      stage_input(stage, x, tile_of(t + gridDim.x, th, tw), Ho, Wo);",
                 "      ;")],
    # no f32 -> bf16 strip conversion
    "noconvert": [(STEM, "for (int i = threadIdx.x; i < kInH * kInW * (kK / 2); i += kThreads) {",
                   "for (int i = threadIdx.x; i < 0; i += kThreads) {")],
    # no output stores
    "nostore": [(STEM, "*reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);",
                 ";")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_stem needs a CUDA card")
    print_card()
    libs = build_variants("stem", VARIANTS)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)

    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    Ho, Wo = 304, 512
    s2d = tens(rng.randn(1, 12, Ho, Wo) * 40)
    w4 = conv1_w4(tens(rng.randn(64, 3, 7, 7) * (1 / 147) ** 0.5)).contiguous()
    scale, bias = tens(rng.uniform(0.5, 2, 64)), tens(rng.randn(64))
    wf = ST.stem_weight_fragments(w4)
    run(libs, "stem", lambda: ST._launch(s2d, wf, scale, bias),
        f"stem B=1 Ho={Ho} Wo={Wo}")
    cases = [(s2d, w4, scale, bias)]
    s2d2 = tens(np.random.RandomState(1).randn(2, 12, Ho, Wo) * 40)
    cases.append((s2d2, w4, scale, bias))
    for x, w, sc, b in cases:
        error_report(libs, x, w, sc, b)


def error_report(libs, s2d, w4, scale, bias) -> None:
    """The tensor cores' sums alone (variant noexact) and the full kernel
    against the plain version at one input (see the module docstring)."""
    wf = ST.stem_weight_fragments(w4)
    want = ST.stem_reference(s2d, w4, scale, bias).float()
    # scale 1, bias 0: a flipped rounding of y = acc shows an error at least
    # the distance from the exact acc to the bf16 rounding midpoint it crossed
    ones, zeros = torch.ones_like(scale), torch.zeros_like(bias)
    got = {}
    for var in ("noexact", "full"):
        _build._libs["stem"] = libs[var]
        got[var] = ST._launch(s2d, wf, scale, bias).float()
        if var == "noexact":
            tc1 = ST._launch(s2d, wf, ones, zeros).float()
    _build._libs.pop("stem", None)
    tc = got["noexact"]
    outside = int(((tc - want).abs() > want.abs() * 2.0 ** -7 + 1e-6).sum())
    flips = int((tc != want).sum())
    B, _, Ho, Wo = s2d.shape
    sp = torch.nn.functional.pad(s2d.to(torch.bfloat16).double(), (2, 1, 2, 1))
    taps = torch.cat([sp[:, :, dh:dh + Ho, dw:dw + Wo]
                      for dh in range(4) for dw in range(4)], 1).reshape(B, 192, -1)
    w = w4.to(torch.bfloat16).double()
    acc = torch.einsum("ko,bkn->bon", w, taps).reshape(tc1.shape)
    mag = torch.einsum("ko,bkn->bon", w.abs(), taps.abs()).reshape(tc1.shape)
    y = acc.float().clamp_min(0)
    flip1 = (tc1 != y.to(torch.bfloat16).float()) & (acc.abs() > 2.0 ** -5)
    bits = y.view(torch.int32)
    ulp = torch.ldexp(torch.ones_like(y), ((bits >> 23) & 0xFF) - 150).double()
    dist = ((bits & 0xFFFF).double() - 0x8000).abs() * ulp
    ratio = float((dist / mag)[flip1].max()) if bool(flip1.any()) else 0.0
    # the share of outputs the kernel's flag test sends down the exact path
    # (its test on the exact sums)
    s_, b_ = scale[None, :, None, None], bias[None, :, None, None]
    yb = acc.float() * s_ + b_
    d = s_.abs() * mag.float() * (2.0 ** -20 + 2.0 ** -22) + yb.abs() * 2.0 ** -22
    near = ((yb - d).clamp_min(0).to(torch.bfloat16)
            != (yb + d).clamp_min(0).to(torch.bfloat16))
    print(f"stem B={B} tensor cores alone: {outside} of {want.numel()} outputs "
          f"outside the one-bf16-ulp band, {flips} differ; scale 1: "
          f"{int(flip1.sum())} roundings flipped, largest error shown "
          f"{ratio * 2 ** 23:.3f} x 2^-23 S; exact path share "
          f"{float(near.float().mean()):.4f}; full kernel bit-equal: "
          f"{torch.equal(got['full'], want)}", flush=True)


if __name__ == "__main__":
    main()
