"""Experiment logger and Speedometer (port of relation_tpu/utils/logging.py;
reference lib/utils/create_logger.py:13-36, a file logger under
output/<cfg>/<image_set>/, and core/callback.py:19-51, samples/sec and the
running metric means every ``frequent`` batches)."""

from __future__ import annotations

import logging
import os
import time


def create_logger(output_path: str, cfg_name: str, image_set: str) -> tuple:
    """(logger, output directory): logs to the console and to
    <output_path>/<cfg_name>/<image_set>/<cfg_name>_<time>.log."""
    final_output_path = os.path.join(output_path, cfg_name, image_set)
    os.makedirs(final_output_path, exist_ok=True)
    log_file = os.path.join(
        final_output_path,
        "{}_{}.log".format(cfg_name, time.strftime("%Y-%m-%d-%H-%M")))
    logger = logging.getLogger(f"relation_tpu_torch.{cfg_name}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fh = logging.FileHandler(log_file)
    sh = logging.StreamHandler()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger, final_output_path


class Speedometer:
    """samples/sec and the running metric means every ``frequent`` batches."""

    def __init__(self, logger, batch_size: int, frequent: int = 20):
        self.logger = logger
        self.batch_size = batch_size
        self.frequent = frequent
        self.tic = time.time()
        self.count = 0
        self.sums: dict[str, float] = {}

    def update(self, epoch: int, batch: int, metrics: dict):
        self.count += 1
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        if self.count % self.frequent == 0:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
            means = ", ".join(f"{k}={self.sums[k] / self.count:.4f}"
                              for k in sorted(self.sums))
            self.logger.info(
                f"Epoch[{epoch}] Batch [{batch}] Speed: {speed:.2f} "
                f"samples/sec, {means}")
            self.tic = time.time()
