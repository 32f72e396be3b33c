"""Process groups spawned from one Python process, and the rank functions the
data-parallel checks run (entry.py::dryrun_multichip, the parity tests and
chip_smoke.py's data-parallel phase).

``spawn(fn, world, *args)`` starts ``world`` processes with
torch.multiprocessing, joins them through a ``file://`` store in a fresh
temporary directory (no TCP port, so that several runs can share a host),
calls ``fn(mesh, *args)`` in each and returns the ranks' results in rank
order. ``fn`` must be importable by the children: a module-level function
of this package.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time

import numpy as np
import torch


def spawn(fn, world: int, *args, backend: str = "gloo", device="cpu",
          threads: int | None = None) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank world - 1]; ``device`` is
    every rank's (several gloo ranks may share one card), ``threads`` the
    CPU threads of each rank. The ranks take this process's TF32 switches
    (a fresh process would compute its f32 convolutions in TF32)."""
    import torch.multiprocessing as mp
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(world, fn, init, tmp, backend, str(device),
                                   threads, tf32, args),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank, world, fn, init, tmp, backend, device, threads, tf32,
               args):
    import torch.distributed as dist
    from relation_tpu_torch.parallel.mesh import make_mesh
    if threads:
        torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    mesh = make_mesh(backend=backend, device=device, init_method=init,
                     rank=rank, world_size=world)
    try:
        out = fn(mesh, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def params_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer, in key order: equal digests
    mean bit-equal models."""
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_steps(mesh, cfg, batch: dict, tiny: bool = False,
                steps: int = 1) -> dict:
    """``steps`` train steps of a model built from ``cfg`` with
    ``init_params(seed=0)`` weights and a state seeded with 0, on ``mesh``
    (one process or a rank of a group: then ``batch`` is the global batch
    and the rank trains on its share). Returns {"metrics": [per step],
    "step_s": [per step], "digest": params_digest after the first step,
    "params": {key: numpy} after the first step, "init": {key: numpy}
    before it (both on rank 0 only)}."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.trainer import (build_model, create_train_state,
                                                 make_train_step)
    from relation_tpu_torch.parallel.mesh import replicated, shard_batch
    model = init_params(build_model(cfg, tiny=tiny, device=mesh.device), seed=0)
    state = replicated(mesh, create_train_state(model, cfg, seed=0))
    step = make_train_step(model, cfg, device=mesh.device, mesh=mesh)
    shard = shard_batch(mesh, batch)
    keep = mesh.rank == 0

    def snapshot():
        return {k: v.detach().float().cpu().numpy().copy()
                for k, v in model.state_dict().items()}
    out = {"metrics": [], "step_s": []}
    if keep:
        out["init"] = snapshot()
    for i in range(steps):
        _sync(mesh.device)
        t0 = time.perf_counter()
        state, m = step(state, shard)
        metrics = {k: float(v) for k, v in m.items()}
        _sync(mesh.device)
        out["step_s"].append(time.perf_counter() - t0)
        out["metrics"].append(metrics)
        if i == 0:
            out["digest"] = params_digest(model)
            if keep:
                out["params"] = snapshot()
    return out


def update_agreement(init: dict, ref: dict, new: dict) -> dict:
    """How far the update new - init is from ref - init: the global
    relative L2 error, the largest relative error of a leaf among those
    carrying at least 10% of the update's global norm, the largest error
    of any leaf relative to the global norm, the two updates' global norms
    and the number of leaves the reference moved."""
    upd = {k: ((ref[k] - init[k]).astype(np.float64).ravel(),
               (new[k] - init[k]).astype(np.float64).ravel()) for k in ref}
    norm = float(np.sqrt(sum(float(r @ r) for r, _ in upd.values())))
    err = float(np.sqrt(sum(float((d - r) @ (d - r)) for r, d in upd.values())))
    worst = 0.0
    for r, d in upd.values():
        n_ref = float(np.linalg.norm(r))
        if n_ref >= 0.1 * norm and n_ref > 0:
            worst = max(worst, float(np.linalg.norm(d - r)) / n_ref)
    new_norm = float(np.sqrt(sum(float(d @ d) for _, d in upd.values())))
    leaf_of_norm = max(float(np.linalg.norm(d - r)) for r, d in upd.values())
    return {"global_rel": err / max(norm, 1e-30), "leaf_rel": worst,
            "leaf_of_norm": leaf_of_norm / max(norm, 1e-30), "norm": norm,
            "norm_new": new_norm,
            "moved": sum(int(np.any(r != 0)) for r, _ in upd.values())}


def pred_eval_rank(mesh, cfg, root: str, image_set: str, tiny: bool = False,
                   arrays: dict | None = None) -> dict:
    """core/evaluator.py::pred_eval over the COCO-layout dataset ``root`` /
    ``image_set`` with ``init_params(seed=0)`` weights on ``mesh``; ``arrays``
    (tools/mini_coco.py's) in place of the image files. Returns {"dets":
    {image_id: dets}, "stats": pred_eval's timing split}."""
    from relation_tpu_torch.convert import init_params
    from relation_tpu_torch.core.evaluator import pred_eval
    from relation_tpu_torch.core.trainer import build_model
    from relation_tpu_torch.data.coco import coco_dataset
    from relation_tpu_torch.data.loader import TestLoader
    from relation_tpu_torch.tools.mini_coco import array_loader
    model = init_params(build_model(cfg, tiny=tiny, device=mesh.device), seed=0)
    dataset = coco_dataset(root, image_set)
    roidb = dataset.roidb()
    loader = None if arrays is None else TestLoader(
        roidb, cfg, image_loader=array_loader(arrays))
    stats: dict = {}
    _, dets = pred_eval(model, cfg, dataset, roidb, loader=loader, mesh=mesh,
                        stats=stats)
    return {"dets": dets, "stats": stats}


def kernel_launches() -> dict:
    """{"module.counter": value} of every launch counter of ops/kernels (the
    integers named *launches, and the dicts of launches by shape named
    *launch_shapes) in this process."""
    import importlib
    import pkgutil
    import relation_tpu_torch.ops.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for attr, v in vars(mod).items():
            if attr.endswith("launches") and isinstance(v, int):
                out[f"{info.name}.{attr}"] = v
            elif attr.endswith("launch_shapes") and isinstance(v, dict):
                out[f"{info.name}.{attr}"] = dict(v)
    return out


def train_and_eval_rank(mesh, cfg, batch: dict, steps: int, eval_cfg,
                        root: str, image_set: str, tiny: bool = False,
                        arrays: dict | None = None) -> dict:
    """``train_steps`` then ``pred_eval_rank`` (each on a model of its own)
    in one rank, with this process's kernel launches of each part (the
    counters start at zero in a spawned rank)."""
    out = {"train": train_steps(mesh, cfg, batch, tiny=tiny, steps=steps)}
    out["train_launches"] = kernel_launches()
    if torch.device(mesh.device).type == "cuda":
        torch.cuda.empty_cache()
    out["eval"] = pred_eval_rank(mesh, eval_cfg, root, image_set, tiny=tiny,
                                 arrays=arrays)
    out["launches"] = kernel_launches()
    return out


def run_driver(mesh, module: str, argv: list) -> dict:
    """``main(argv)`` of a driver module (e.g.
    "relation_tpu_torch.experiments.train") in this rank, inside the process
    group the rank already joined; returns its last metrics and the files
    it names."""
    import importlib
    out = importlib.import_module(module).main(argv)
    return {"metrics": out.get("metrics", {}),
            "files": {k: out[k] for k in ("checkpoint", "params") if k in out}}
