"""Where the time of the geometric-bias backward (csrc/geom_bias_bwd.cu), of
the bias attention (csrc/bias_attention.cu) and of the fused learned-NMS
attention (csrc/nms_attention.cu) goes, on one CUDA card, by switching their
parts off one at a time.

    python3 -m relation_tpu_torch.tools.ablate_attention [--only nms_attention]

Builds variants of the two sources, each a few text substitutions away from
the source (the .cu or a header beside it; tools/_ablate.py: one nvcc per
variant, in parallel, into relation_tpu_torch/_build/ablate_<source>/), and
times each
with CUDA events on seeded inputs at the shapes the model gives them: the
backward without d_pos (as the model runs it) at C=80, N=M=100 and at C=1,
316x300; the bias attention over 80 classes at N=100 and N=150, and over 16
of 80 at N=150; the fused attention over 80 classes at N=100 and over 16 of
80 at N=100 and N=150. A variant that switches a part off computes garbage; a time
marked * is from a variant whose output differs from the full kernel's.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from relation_tpu_torch.ops.embeddings import (extract_multi_position_matrix_t,
                                               extract_position_matrix_t)
from relation_tpu_torch.ops.kernels import _build
from relation_tpu_torch.ops.kernels import bias_attention as BA
from relation_tpu_torch.ops.kernels import geom_bias as GB
from relation_tpu_torch.ops.kernels import nms_attention as NA
from relation_tpu_torch.tools._ablate import build_variants, print_card, time_ms

BWD, ATT, NMS = "geom_bias_bwd.cu", "bias_attention.cu", "nms_attention.cu"
# one TF32 pass in place of three (wrong sums): mma3's two small products
MMA1 = ("mma_tf32.cuh", "  mma(d, al, bh);\n  mma(d, ah, bl);\n", "")
# TF32 rounding by cvt.rna in place of the integer add and mask (the same
# values)
CVTROUND = ("mma_tf32.cuh",
            "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
            '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
            "  return r;")
TC = "attention_tc.cuh"
VARIANTS = {
    "geom_bias_bwd": {
        "full": [],
        # no d_W/d_b product on the tensor cores
        "nodw": [(BWD, "dwb_product<G>(acc, tw, dw, lane);", "")],
        # three blocks an SM (registers capped at 168)
        "blocks3": [(BWD, "constexpr int kMinBlocks = 4;",
                     "constexpr int kMinBlocks = 3;")],
        "mma1": [MMA1],
        "cvtround": [CVTROUND],
        # the accurate sincosf replaced by the fast approximation
        "fasttrig": [("geom_trig.cuh",
                      "sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs[h][kk]);",
                      "__sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs[h][kk]);")],
    },
    "bias_attention": {
        "full": [],
        # no value projection; no attention kernel (the projection alone)
        "noproj": [(ATT, "cudaError_t err = launch_value_proj(",
                    "cudaError_t err = cudaSuccess; if (0) launch_value_proj(")],
        "noattn": [(ATT, "  const int nt = (chunk_keys(N) + 7) / 8;\n",
                    "  return 0;\n  const int nt = (chunk_keys(N) + 7) / 8;\n")],
        # no QK^T, no softmax, no attn @ u
        "noqk": [(ATT, "      scores<NT>(s, qs, ks, r0, sh, inv_sqrt_d, lane);",
                  "")],
        "nosoftmax": [(TC, "softmax_rows<NT>(s, m, l, scale, first);",
                       "scale[0] = scale[1] = 0.f; l[0] = l[1] = 1.f;")],
        "nopv": [(TC, "attn_times_u<NT>(s, us, sh.US, e0, lane, o);", "")],
        # no global reads by cp.async (zero fill only)
        "noload": [(TC, "cp_async16(dst + j * ds + e, ok ? src + j * ld + e : src, ok);",
                    "cp_async16(dst + j * ds + e, src, false);"),
                   (ATT, "cp_async16(bs + i, src + i, true);",
                    "cp_async16(bs + i, src, false);")],
        "mma1": [(TC, "        if (n0 + j < NT) tf32::mma(s[n0 + j], al, bh[j]);", ""),
                 (TC, "        if (n0 + j < NT) tf32::mma(s[n0 + j], ah, bl[j]);", ""),
                 (TC, "    tf32::mma(o1, al, bh);\n    tf32::mma(o2, ah, bl);\n", ""),
                 MMA1],
        # other shapes of the QK^T loop: two k8 steps unrolled; eight or two
        # n8 tiles a group in place of four
        "unroll2": [(TC, "#pragma unroll 1\n  for (int kk = 0; kk < sh.KS; ++kk) {",
                     "#pragma unroll 2\n  for (int kk = 0; kk < sh.KS; ++kk) {")],
        "group8": [(TC, "for (int n0 = 0; n0 < NT; n0 += 4) {",
                    "for (int n0 = 0; n0 < NT; n0 += 8) {"),
                   (TC, "uint32_t bh[4][2], bl[4][2];", "uint32_t bh[8][2], bl[8][2];"),
                   (TC, "for (int j = 0; j < 4; ++j)", "for (int j = 0; j < 8; ++j)")],
        "group2": [(TC, "for (int n0 = 0; n0 < NT; n0 += 4) {",
                    "for (int n0 = 0; n0 < NT; n0 += 2) {"),
                   (TC, "for (int j = 0; j < 4; ++j)", "for (int j = 0; j < 2; ++j)")],
        "cvtround": [CVTROUND],
    },
    "nms_attention": {
        "full": [],
        # clusters of at most 8 heads (the bias trig twice a class at G=16)
        "cs8": [(NMS, "  if (G % 16 == 0) {\n    cudaError_t err = launch<NT, 2>",
                 "  if (false) {\n    cudaError_t err = launch<NT, 2>")],
        # the accurate sincosf replaced by its argument (no trig)
        "notrig": [(NMS, "sincosf(__fmul_rn(pj, fr[kk]), &sn[h][kk], &cs_[h][kk]);",
                    "sn[h][kk] = cs_[h][kk] = __fmul_rn(pj, fr[kk]);")],
        # the trig kept, the bias product on the tensor cores dropped
        "nobiasmma": [(NMS, "tf32::mma3(acc[nb], ah, al, bh[nb][2 * j + half], "
                       "bl[nb][2 * j + half]);",
                       "acc[nb][0] += a[0] + a[1] + a[2] + a[3];")],
        # no bias at all (tiles left as they are)
        "nobias": [(NMS, "      bias_share<NB>(bs, pos, wg, bg, x, sh, scale, cs, "
                    "rank, cluster);\n", "")],
        # every head's bias written into the block's own tile, block
        # barriers in place of the cluster barriers
        "nocsync": [(NMS, "dst[nb][e] = h < cs ? cluster.map_shared_rank(bs, h) : nullptr;",
                     "dst[nb][e] = h < cs ? bs : nullptr;"),
                    (NMS, "      cluster.sync();\n", "      __syncthreads();\n")],
        # no q k^T
        "noqk": [(TC, "#pragma unroll 1\n  for (int kk = 0; kk < sh.KS; ++kk) {",
                  "#pragma unroll 1\n  for (int kk = 0; kk < 0; ++kk) {")],
        # no softmax and P u (no output written)
        "nofinish": [(NMS, "      finish<NT>(s, m, l, kc == 0, !same, ub[cur], out, x, "
                      "r0, sh, lane);", "")],
        # no value projection kernel (u left as allocated)
        "noproj": [(NMS, "cudaError_t err = launch_value_proj(v, wl, active, u, C, N, "
                    "F, G, E, s);", "cudaError_t err = cudaSuccess;")],
    },
}


def run(libs, name, call, label, rows=None):
    """Time ``call`` (which runs the wrapper of ``name``) on each variant's
    library, put in the wrapper's place; ``rows`` picks the rows of its
    output that are compared with the full kernel's."""
    row, want = [], None
    for var, lib in libs.items():
        _build._libs[name] = lib
        out = call()
        torch.cuda.synchronize()
        if rows is not None:
            out = out[rows]
        if want is None:
            want = out
        mark = "" if torch.equal(out, want) else "*"
        row.append(f"{var} {time_ms(call):.4f}{mark}")
    _build._libs.pop(name, None)
    print(f"{label}: " + "; ".join(row), flush=True)


def boxes(rng, n, im_w=1000.0, im_h=600.0, clusters=60):
    """Clustered boxes like RPN proposals: [n, 4] (x1, y1, x2, y2) f32."""
    centers = rng.uniform([0, 0], [im_w, im_h], (clusters, 2))
    cxy = centers[rng.randint(0, clusters, n)] + rng.randn(n, 2) * 12
    wh = np.exp(rng.uniform(np.log(16), np.log(400), (n, 2)))
    b = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)
    return b.astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=sorted(VARIANTS), action="append",
                    help="ablate these sources only (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_attention needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print_card()
    names = args.only or list(VARIANTS)
    libs = {name: build_variants(name, VARIANTS[name]) for name in names}
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)

    def tens(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    G, D, Fd, E = 16, 64, 128, 8
    w, b = tens(rng.randn(64, G) * 0.1), tens(rng.randn(G) * 0.05)
    bwd_cases = ()
    if "geom_bias_bwd" in libs:
        bwd_cases = (
            ("geom_bias_bwd C=80 N=M=100", extract_multi_position_matrix_t(
                tens(np.stack([boxes(rng, 100) for _ in range(80)], 1)))),
            ("geom_bias_bwd C=1 N=316 M=300", extract_position_matrix_t(
                tens(boxes(rng, 316)), 300)[None]))
    for label, pos in bwd_cases:
        pos = pos.contiguous()
        gout = tens(rng.randn(pos.shape[0], G, *pos.shape[2:]))
        run(libs["geom_bias_bwd"], "geom_bias_bwd",
            lambda: GB._launch_bwd(pos, w, b, gout, 100.0, need_pos=False)[1],
            label)
    for N, n_active in ((100, 80), (150, 80), (150, 16)):
        if "bias_attention" not in libs:
            break
        C = 80
        pos = extract_multi_position_matrix_t(
            tens(np.stack([boxes(rng, N) for _ in range(C)], 1))).contiguous()
        bias = GB.geom_bias_reference(pos, w, b).contiguous()
        del pos
        q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
        v, wl = tens(rng.randn(C, N, Fd)), tens(rng.randn(G, Fd, E) * 0.1)
        act = np.zeros(C, np.int32)
        act[rng.choice(C, n_active, replace=False)] = 1
        active = torch.tensor(act, device=dev)
        if n_active == C:
            def call():
                return BA.fused_bias_attention(bias, q, k, v, wl)
        else:
            def call():
                return BA.fused_bias_attention_skip(bias, q, k, v, wl, active)
        run(libs["bias_attention"], "bias_attention", call,
            f"bias_attention C={C} N={N} active={n_active}",
            rows=None if n_active == C else active.bool())
    for N, n_active in ((100, 80), (100, 16), (150, 16)):
        if "nms_attention" not in libs:
            break
        C = 80
        pos = extract_multi_position_matrix_t(
            tens(np.stack([boxes(rng, N) for _ in range(C)], 1))).contiguous()
        q, k = tens(rng.randn(C, N, G * D) * 0.5), tens(rng.randn(C, N, G * D) * 0.5)
        v, wl = tens(rng.randn(C, N, Fd)), tens(rng.randn(G, Fd, E) * 0.1)
        act = np.zeros(C, np.int32)
        act[rng.choice(C, n_active, replace=False)] = 1
        active = torch.tensor(act, device=dev)
        if n_active == C:
            def call():
                return NA.fused_nms_relation_attention(pos, q, k, v, w, b, wl)
        else:
            def call():
                return NA.fused_nms_relation_attention_skip(pos, q, k, v, w, b,
                                                            wl, active)
        run(libs["nms_attention"], "nms_attention", call,
            f"nms_attention C={C} N={N} active={n_active}",
            rows=None if n_active == C else active.bool())


if __name__ == "__main__":
    main()
