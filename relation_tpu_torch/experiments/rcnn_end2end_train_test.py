"""End-to-end train then test (counterpart of
experiments/rcnn_end2end_train_test.py; reference experiments/relation_rcnn/
rcnn_end2end_train_test.py): experiments/train.py, then experiments/test.py
on the last trained epoch's params (relation_rcnn/train_end2end.py:151-152
writes them, relation_rcnn/test.py:67 loads cfg.TEST.test_epoch's).

    python -m relation_tpu_torch.experiments.rcnn_end2end_train_test \\
        --cfg <yaml> [--steps K] [--tiny] [--device cpu] [test flags]

One argv goes to both drivers, each of which tolerates the other's flags.
Both run in this process.
"""

from __future__ import annotations

import os
import sys


def final_params_path(cfg_path: str) -> str:
    """Where the train driver saves the params file of TRAIN.end_epoch."""
    from relation_tpu_torch.config.defaults import load_config
    from relation_tpu_torch.experiments.test import epoch_params_path
    cfg = load_config(cfg_path)
    return epoch_params_path(cfg, cfg_path, int(cfg.TRAIN.end_epoch))


def trained_params_path(cfg_path: str) -> str:
    """``final_params_path``, or where the train driver stopped short of
    TRAIN.end_epoch (--steps), the newest params file it wrote."""
    ckpt = final_params_path(cfg_path)
    if os.path.exists(ckpt):
        return ckpt
    d = os.path.dirname(ckpt)
    cands = sorted(f for f in (os.listdir(d) if os.path.isdir(d) else ())
                   if f.endswith(".params.msgpack"))
    if not cands:
        raise FileNotFoundError(f"no trained params under {d}")
    return os.path.join(d, cands[-1])


def main(argv=None):
    """Trains, then tests; returns the test driver's (results, dets)."""
    from relation_tpu_torch.experiments import test, train
    args = list(sys.argv[1:] if argv is None else argv)
    train.main(args)
    if "--ckpt" not in args:
        args += ["--ckpt", trained_params_path(args[args.index("--cfg") + 1])]
    return test.main(args)


if __name__ == "__main__":
    main()
