"""How far one unclipped train step is reproducible on the card: the same
step from the same weights, run several times on the kernels and several
times on the plain versions, and the distance between every pair of runs.

    python3 -m relation_tpu_torch.tools.train_step_spread --family dcn_learn_nms
    python3 -m relation_tpu_torch.tools.train_step_spread --family dcn_learn_nms --f32

Card only (~35 s a call). It builds the family as chip_smoke.py's training
phase does (full width, B=2, the same seeded batch, offsets seeded for a
DCN family, no gradient clip), takes ``--kernel`` steps on the kernels and
``--plain`` steps on the plain versions, each from a fresh model with the
same start, and prints for each run its losses and the L2 norm of its
update, for pairs of runs the distance of their updates over the update's
norm (``||du||/||u||``) with the leaves that carry most of it, and the
range of the relative update-norm difference over all kernel/plain pairs
(the quantity chip_smoke.py holds to 1e-3). The start is the bf16 model's,
as in chip_smoke.py; ``--f32`` runs the compared steps with the trunk, the
head and the DCN pools in f32.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="dcn_learn_nms")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--kernel", type=int, default=3)
    ap.add_argument("--plain", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_step_spread: needs a CUDA card")
    import chip_smoke as cs
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    from relation_tpu_torch.entry import BUCKET, family_cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    batch = cs.training_batch(*BUCKET)

    def fresh(weights=None, f32=False):
        cfg = family_cfg(args.family)
        cfg.TPU.GRAD_CLIP = 0.0
        if f32:
            cfg.TPU.COMPUTE_DTYPE = cfg.TPU.HEAD_DTYPE = "float32"
            cfg.TPU.DCN_POOL_DTYPE = "float32"
        model = build_model(cfg, device=dev)
        if weights is not None:
            model.load_state_dict(weights)
        else:
            init_params(model, seed=0)
            if args.family.startswith("dcn"):
                cs.seed_offsets(torch, model, cfg, batch["image"][0],
                                batch["im_info"][0])
        return model, create_train_state(model, cfg, seed=0), \
            make_train_step(model, cfg, device=dev)

    model, _, _ = fresh()
    start = {n: v.detach().clone() for n, v in model.state_dict().items()}
    del model

    def norm(u):
        return sum(float((v.double() ** 2).sum()) for v in u.values()) ** 0.5

    runs = []
    for tag in "K" * args.kernel + "P" * args.plain:
        with cs.plain_kernels() if tag == "P" else contextlib.nullcontext():
            model, state, step = fresh(start, args.f32)
            cs.zero_counters()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: n for k, n in cs.read_launches(cs.COUNTERS).items() if n}
            upd = {n: (p.detach() - start[n]).float()
                   for n, p in model.named_parameters()}
        del model, state, step
        losses = {k: float(v) for k, v in m.items() if k.endswith("loss")}
        runs.append((tag, upd))
        print(f"{tag}{len(runs) - 1}: update norm {norm(upd)!r}; {ms:.1f} ms; "
              f"losses {losses}; launches {launches}", flush=True)

    def compare(i, j):
        a, b = runs[i][1], runs[j][1]
        d = {n: float(((a[n].double() - b[n].double()) ** 2).sum()) ** 0.5
             for n in a}
        total = sum(x * x for x in d.values()) ** 0.5
        top = sorted(d.items(), key=lambda t: -t[1])[:3]
        print(f"{runs[i][0]}{i} vs {runs[j][0]}{j}: ||du||/||u|| "
              f"{total / norm(a):.3e}; largest: " + "; ".join(
                  f"{n} ||du|| {x:.3e} of ||u|| "
                  f"{float((a[n].double() ** 2).sum()) ** 0.5:.3e}"
                  for n, x in top))

    big = sorted(runs[0][1].items(), key=lambda t: -float((t[1].double() ** 2).sum()))
    print("largest leaves of the first update: " + "; ".join(
        f"{n} {float((v.double() ** 2).sum()) ** 0.5:.4e}" for n, v in big[:4]))
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            compare(i, j)
    ks = [norm(u) for t, u in runs if t == "K"]
    ps = [norm(u) for t, u in runs if t == "P"]
    rel = [abs(k - p) / p for k in ks for p in ps]
    if rel:
        print(f"update norm, kernel vs plain: relative difference {min(rel):.3e} "
              f"to {max(rel):.3e} over {len(rel)} pairs "
              f"({'f32' if args.f32 else 'bf16'}, {args.family})")


if __name__ == "__main__":
    main()
