"""The bias attention (rows 7 and 8, csrc/bias_attention.cu) built from this
checkout's sources and from another checkout's, on one CUDA card: the same
seeded inputs through both libraries behind the same wrapper, outputs
compared bit for bit, times taken in turns (other, this, this, other) in
one process.

    python3 -m relation_tpu_torch.tools.compare_builds --other DIR/relation_tpu_torch/csrc

Shapes: chip_smoke.py's rows 7/8 (80 classes at N=100 and N=150, 16 of 80
at N=150, 4 classes at N=408). Prints the card's name and power limit first.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from relation_tpu_torch.ops.embeddings import extract_multi_position_matrix_t
from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import bias_attention as BA
from relation_tpu_torch.ops.kernels import geom_bias as GB
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms
from relation_tpu_torch.tools.ablate_attention import boxes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc/ directory of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print_card()
    libs = {"other": build_variants("bias_attention", {"other": []},
                                    csrc=args.other, tag="compare")["other"],
            "this": build_variants("bias_attention", {"this": []},
                                   tag="compare_this")["this"]}
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)

    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    G, D, Fd, E = 16, 64, 128, 8
    w, b = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    for C, N, n_active in ((80, 100, 80), (80, 150, 80), (80, 150, 16),
                           (4, 408, 4)):
        pos = extract_multi_position_matrix_t(
            tens(np.stack([boxes(rng, N) for _ in range(C)], 1))).contiguous()
        bias = GB.geom_bias_reference(pos, w, b).contiguous()
        del pos
        q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
        v, wl = tens(rng.randn(C, N, Fd)), tens(rng.randn(G, Fd, E) * 0.1)
        act = np.zeros(C, np.int32)
        act[rng.choice(C, n_active, replace=False)] = 1
        active = torch.tensor(act, device=dev)
        on = active.bool()
        if n_active == C:
            def call():
                return BA.fused_bias_attention(bias, q, k, v, wl)
        else:
            def call():
                return BA.fused_bias_attention_skip(bias, q, k, v, wl, active)
        outs, times = {}, []
        for which in ("other", "this", "this", "other"):
            _build._libs["bias_attention"] = libs[which]
            outs[which] = call()[on]
            times.append(f"{which} {time_ms(call, reps=21):.4f}")
        _build._libs.pop("bias_attention", None)
        same = torch.equal(outs["other"], outs["this"])
        row = "row 7" if n_active == C else "row 8"
        print(f"{row} C={C} N={N} active={n_active}: outputs bit-equal: {same}; "
              f"ms {'; '.join(times)}", flush=True)


if __name__ == "__main__":
    main()
